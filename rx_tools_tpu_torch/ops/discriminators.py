"""FM discriminators (quadrature demodulation), in PyTorch.

Counterpart of :mod:`rx_tools_tpu.ops.discriminators`.  The reference
offers four per-sample discriminators selected by ``-A`` (``fm_demod``
dispatch, ``src/rtl_fm.c:584-615``); all compute the angle of
``s[n] * conj(s[n-1])`` in units where pi == ``1<<14``, using the literal
3.14159 as the scale divisor (``src/rtl_fm.c:482``).

- ``std``  — true atan2 (:func:`polar_discriminant`)
- ``fast`` — octant linear-blend approximation (:func:`fast_atan2`)
- ``lut``  — the reference's 512 KB atan LUT, bit-faithful
  (:func:`polar_disc_lut`)
- ``ale``  — the atan-free Esbensen discriminator (:func:`esbensen_disc`)

Sample 0 of every block uses the *std* atan2 regardless of mode, exactly
what ``fm_demod`` does for the seam sample (``rtl_fm.c:588-590``).

The std atan2 evaluates in float64 and rounds once to float32: PyTorch's
CPU float32 ``atan2`` takes a vector path or a scalar path depending on a
sample's position in the tensor, which would make a seam's value depend
on how many blocks a call holds.  The rounded float64 result is the same
on every path and device; it sits within an ulp of the float32 ``atan2``
of the reference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rx_tools_tpu_torch.ops.numeric import device_const, div_const

DISC_STD, DISC_FAST, DISC_LUT, DISC_ALE = 0, 1, 2, 3
_NAMES = {"std": DISC_STD, "fast": DISC_FAST, "lut": DISC_LUT, "ale": DISC_ALE}

_PI_REF = float(np.float32(3.14159))     # the reference's scale constant
_SCALE = float(1 << 14)


def disc_mode(name: str) -> int:
    return _NAMES[name]


def polar_discriminant(cr: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """angle(c) scaled so pi -> 1<<14, via true atan2."""
    a = torch.atan2(cj.double(), cr.double()).float()
    return div_const(a, _PI_REF) * _SCALE


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Float port of the integer octant approximation (rtl_fm.c:485-506).

    pi4 = 1<<12, pi34 = 3<<12; linear blend on (x-|y|)/(x+|y|).
    """
    pi4 = float(1 << 12)
    pi34 = float(3 * (1 << 12))
    yabs = torch.abs(y)
    pos = pi4 - pi4 * (x - yabs) / (x + yabs)
    neg = pi34 - pi4 * (x + yabs) / (yabs - x)
    angle = torch.where(x >= 0, pos, neg)
    angle = torch.where((x == 0) & (y == 0), torch.zeros_like(angle), angle)
    return torch.where(y < 0, -angle, angle)


def polar_disc_fast(cr: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    return fast_atan2(cj, cr)


_ATAN_LUT_COEF = 8                       # rtl_fm.c:92
_ATAN_LUT_SIZE = 131072                  # rtl_fm.c:93


@functools.lru_cache(maxsize=1)
def _atan_lut_host() -> np.ndarray:
    """The reference's LUT, built exactly like ``atan_lut_init``
    (rtl_fm.c:515-526): libm double atan, the 3.14159 literal, C int cast
    (truncation; entries are non-negative so == floor).  Built once."""
    return np.array(
        [int(math.atan(i / (1 << _ATAN_LUT_COEF)) / 3.14159 * (1 << 14))
         for i in range(_ATAN_LUT_SIZE)], np.int32)


def polar_disc_lut(cr: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """Bit-faithful LUT discriminator (``polar_disc_lut``, rtl_fm.c:528-564).

    Float inputs are rounded to integers first (the reference's ``cr``/``cj``
    are exact integers); integer inputs are used as they are.  Quirks kept:
    C truncating division in ``x = (cj << 8) / cr``, the x==0 else-branch
    (rtl_fm.c:557-561), saturation to +/-(1<<13) when |x| >= the table
    size, and the cr==0 / cj==0 ladder (rtl_fm.c:535-546).
    """
    lut = device_const(_atan_lut_host, device=cr.device)
    if cr.dtype.is_floating_point:
        cri = torch.round(cr).to(torch.int64)
        cji = torch.round(cj).to(torch.int64)
    else:
        cri = cr.to(torch.int64)
        cji = cj.to(torch.int64)
    num = cji << _ATAN_LUT_COEF
    den = torch.where(cri == 0, torch.ones_like(cri), cri)
    x = torch.div(num, den, rounding_mode="trunc")      # C '/' truncates
    x_abs = torch.abs(x)
    l = lut[torch.clamp(x_abs, 0, _ATAN_LUT_SIZE - 1)]
    pos = torch.where(cji > 0, l, l - (1 << 14))
    neg = torch.where(cji > 0, (1 << 14) - l, -l)
    r = torch.where(x > 0, pos, neg)

    def put(cond, value):
        return torch.where(cond, torch.full_like(r, value), r)

    r = torch.where(x_abs >= _ATAN_LUT_SIZE,
                    torch.where(cji > 0, torch.full_like(r, 1 << 13),
                                torch.full_like(r, -(1 << 13))), r)
    r = put((cji == 0) & (cri > 0), 0)
    r = put((cji == 0) & (cri < 0), 1 << 14)
    r = put((cri == 0) & (cji > 0), 1 << 13)
    r = put((cri == 0) & (cji < 0), -(1 << 13))
    r = put((cri == 0) & (cji == 0), 0)
    return r.to(torch.float32)


def esbensen_disc(ar, aj, br, bj):
    """Atan-free: ``imag(ds * conj(s)) / |s|^2`` (rtl_fm.c:566-582).

    ``(ar,aj)`` = current sample, ``(br,bj)`` = previous; the reference's
    +1 in the denominator is kept for value parity.
    """
    scaled_pi = 2608.0           # (1<<14) / (2*pi), reference constant
    dr = (br - ar) * 2.0
    dj = (bj - aj) * 2.0
    cj = bj * dr - br * dj
    return scaled_pi * cj / (ar * ar + aj * aj + 1.0)


def _lut_products(ar, aj, br, bj):
    # int products from the rounded stream: float32 products are exact
    # only below 2**24 (rtl_fm.c's lp[] is int16, so its products are ints)
    ai, ji = torch.round(ar).to(torch.int64), torch.round(aj).to(torch.int64)
    bi, qi = torch.round(br).to(torch.int64), torch.round(bj).to(torch.int64)
    return ai * bi + ji * qi, ji * bi - ai * qi


def fm_discriminate_planar(prev: torch.Tensor, zi: torch.Tensor,
                           zq: torch.Tensor, mode: int,
                           seam_stride: int | None = None):
    """Planar-I/Q FM discriminator: ``zi``/``zq`` (K,) float32, ``prev``
    (2,) the carried previous sample.  Returns ``(new_prev (2,), d (K,))``
    with the std-atan seam at index 0, or every ``seam_stride`` samples
    (a flat chunk of blocks)."""
    ar, aj = zi, zq
    br = torch.cat([prev[0:1], zi[:-1]])
    bj = torch.cat([prev[1:2], zq[:-1]])
    cr = ar * br + aj * bj
    cj = aj * br - ar * bj
    if mode == DISC_STD:
        d = polar_discriminant(cr, cj)
    elif mode in (DISC_FAST, DISC_LUT, DISC_ALE):
        if mode == DISC_FAST:
            d = polar_disc_fast(cr, cj)
        elif mode == DISC_LUT:
            d = polar_disc_lut(*_lut_products(ar, aj, br, bj))
        else:
            d = esbensen_disc(ar, aj, br, bj)
        stride = d.shape[0] if seam_stride is None else int(seam_stride)
        idx = torch.arange(0, d.shape[0], stride, device=d.device)
        d[idx] = polar_discriminant(cr[idx], cj[idx])
    else:
        raise ValueError(f"bad discriminator mode {mode}")
    return torch.stack([zi[-1], zq[-1]]), d


def fm_discriminate_batch_planar(prev: torch.Tensor, zi: torch.Tensor,
                                 zq: torch.Tensor, mode: int):
    """Planar discriminator over a channel stack: ``zi``/``zq`` (C, M),
    ``prev`` (C, 2) each channel's carried previous sample.  Returns
    ``(new_prev (C, 2), d (C, M))`` with one std-atan seam per channel at
    column 0 (rtl_fm.c:588-590)."""
    ar, aj = zi, zq
    br = torch.cat([prev[:, 0:1], zi[:, :-1]], dim=1)
    bj = torch.cat([prev[:, 1:2], zq[:, :-1]], dim=1)
    cr = ar * br + aj * bj
    cj = aj * br - ar * bj
    if mode == DISC_STD:
        d = polar_discriminant(cr, cj)
    elif mode in (DISC_FAST, DISC_LUT, DISC_ALE):
        if mode == DISC_FAST:
            d = polar_disc_fast(cr, cj)
        elif mode == DISC_LUT:
            d = polar_disc_lut(*_lut_products(ar, aj, br, bj))
        else:
            d = esbensen_disc(ar, aj, br, bj)
        d[:, 0] = polar_discriminant(cr[:, 0], cj[:, 0])
    else:
        raise ValueError(f"bad discriminator mode {mode}")
    return torch.stack([zi[:, -1], zq[:, -1]], dim=-1), d


def fm_discriminate_batch(prev: torch.Tensor, x: torch.Tensor, mode: int):
    """Interleaved form over a channel stack: ``x`` (C, M, 2).  Returns
    ``(new_prev (C, 2), d (C, M))``."""
    _, d = fm_discriminate_batch_planar(prev, x[..., 0], x[..., 1], mode)
    return x[:, -1, :], d


def fm_discriminate(prev: torch.Tensor, x: torch.Tensor, mode: int,
                    seam_stride: int | None = None):
    """Interleaved form: ``x`` (N, 2).  Returns ``(new_prev, d (N,))``."""
    _, d = fm_discriminate_planar(prev, x[:, 0].contiguous(),
                                  x[:, 1].contiguous(), mode, seam_stride)
    return x[-1], d
