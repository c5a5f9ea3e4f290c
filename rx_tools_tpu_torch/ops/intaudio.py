"""``--int-audio``: the bit-exact integer audio tier on int64 tensors.

Counterpart of :mod:`rx_tools_tpu.ops.intaudio`.  Every integer quirk of
the reference's audio chain, reproduced so the PCM matches the C model
bit for bit:

- capture rescale with the float-then-truncate cast (``rtlsdr_callback``,
  ``rtl_fm.c:845-848``), in the C's float32 operation order;
- integer boxcar decimate with the int16 wrap (``low_pass``,
  ``rtl_fm.c:351-371``);
- the integer discriminators: ``fast_atan2``'s truncating divisions at
  full precision (``rtl_fm.c:485-506``), the LUT tier, ``esbensen``
  (``rtl_fm.c:566-582``);
- ``low_pass_simple``'s int16-wrapped group sums (``rtl_fm.c:373-387``);
- ``deemph_filter``'s rounding-toward-average integer IIR
  (``rtl_fm.c:667-682``) — a sequential nonlinear recurrence with no
  exact scan, so on the card it is the hand-written kernel
  ``kernels/csrc/int_deemph.cu`` (:func:`deemph_int`: division by a
  reciprocal, segments whose seams meet inside a halo); its plain version
  walks the carry on the host;
- ``dc_block_audio_filter``'s truncating block-mean EMA
  (``rtl_fm.c:684-697``);
- ``low_pass_real``'s accumulate-and-dump with the truncated divisor
  (``rtl_fm.c:389-409``).

torch has native int64, so the C's intermediate widths need no context
switch; C division truncates toward zero, and every division here says so
(``rounding_mode="trunc"``) where an operand can be negative.  The
per-buffer std-atan2 seam sample (``fm_demod``, rtl_fm.c:588-590) is
patched on the host in float64 (``models/fmint.py``).

Semantics oracle: ``tests/oracles/c_ref.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rx_tools_tpu_torch import kernels
from rx_tools_tpu_torch.kernels import plan
from rx_tools_tpu_torch.ops.discriminators import (_ATAN_LUT_COEF,
                                                   _ATAN_LUT_SIZE,
                                                   _atan_lut_host)
from rx_tools_tpu_torch.ops.numeric import device_const

_I64 = torch.int64


def _i16(v: torch.Tensor) -> torch.Tensor:
    """Wrap to int16 two's complement, keeping the int64 dtype."""
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def _cdiv(a, b):
    """C integer division (truncate toward zero), either sign."""
    return torch.div(a, b, rounding_mode="trunc")


def rescale_int(block_i16: torch.Tensor) -> torch.Tensor:
    """CS16 -> the reference's 8-bit-range ints: ``buf[i] * 1.0f/32767.0f
    * 128.0f + 0.4f`` in float32, then the C cast (truncation)."""
    c1 = float(np.float32(1.0) / np.float32(32767.0))
    y = (block_i16.to(torch.float32) * c1) * 128.0 + float(np.float32(0.4))
    return torch.trunc(y).to(_I64)


def boxcar_int(lp: torch.Tensor, downsample: int) -> torch.Tensor:
    """Integer boxcar decimate of ``lp`` (N, 2) (aligned blocks) with the
    int16 wrap on emit."""
    return _i16(lp.reshape(-1, downsample, 2).sum(dim=1))


def fast_atan2_int(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The integer octant atan2 with truncating divisions at full
    precision."""
    pi4, pi34 = 1 << 12, 3 * (1 << 12)
    yabs = torch.abs(y)
    pos = pi4 - _cdiv(pi4 * (x - yabs), torch.clamp(x + yabs, min=1))
    neg = pi34 - _cdiv(pi4 * (x + yabs), torch.clamp(yabs - x, min=1))
    ang = torch.where(x >= 0, pos, neg)
    ang = torch.where((x == 0) & (y == 0), 0, ang)
    return torch.where(y < 0, -ang, ang)


def esbensen_int(ar, aj, br, bj):
    """rtl_fm.c:566-582 in exact integers."""
    dr = (br - ar) * 2
    dj = (bj - aj) * 2
    cj = bj * dr - br * dj
    return _cdiv(2608 * cj, ar * ar + aj * aj + 1)


def lut_disc_int(cr: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """The LUT discriminator (rtl_fm.c:528-564) on int64 products."""
    lut = device_const(_atan_lut_host, device=cr.device).to(_I64)
    x = _cdiv(cj * (1 << _ATAN_LUT_COEF), torch.where(cr == 0, 1, cr))
    x_abs = torch.abs(x)
    l = lut[torch.clamp(x_abs, 0, _ATAN_LUT_SIZE - 1)]
    pos = torch.where(cj > 0, l, l - (1 << 14))
    neg = torch.where(cj > 0, (1 << 14) - l, -l)
    r = torch.where(x > 0, pos, neg)
    r = torch.where(x_abs >= _ATAN_LUT_SIZE,
                    torch.where(cj > 0, 1 << 13, -(1 << 13)), r)
    r = torch.where((cj == 0) & (cr > 0), 0, r)
    r = torch.where((cj == 0) & (cr < 0), 1 << 14, r)
    r = torch.where((cr == 0) & (cj > 0), 1 << 13, r)
    r = torch.where((cr == 0) & (cj < 0), -(1 << 13), r)
    return torch.where((cr == 0) & (cj == 0), 0, r)


def fm_demod_int(pre: torch.Tensor, zi: torch.Tensor, zq: torch.Tensor,
                 custom_atan: int):
    """Integer FM discriminator over a block, ``pre`` (2,) the carried
    pair.  Sample 0 (the std-atan2 seam) is a placeholder zero that the
    caller patches on the host.  Returns ``(new_pre, d, seam_inputs (4,))``.
    """
    ar, aj = zi, zq
    br = torch.cat([pre[0:1], zi[:-1]])
    bj = torch.cat([pre[1:2], zq[:-1]])
    cr = ar * br + aj * bj
    cj = aj * br - ar * bj
    if custom_atan == 1:
        d = fast_atan2_int(cj, cr)
    elif custom_atan == 2:
        d = lut_disc_int(cr, cj)
    elif custom_atan == 3:
        d = esbensen_int(ar, aj, br, bj)
    else:
        raise ValueError("int tier: -A std demodulates every sample in "
                         "double precision; use fast/lut/ale")
    d = _i16(d)
    d[0] = 0
    seam = torch.stack([zi[0], zq[0], pre[0], pre[1]])
    return torch.stack([zi[-1], zq[-1]]), d, seam


def am_demod_int(zi: torch.Tensor, zq: torch.Tensor, output_scale: int):
    """Envelope with the C's double sqrt truncation (rtl_fm.c:617-632):
    float64 sqrt of an exact int, correctly rounded on every device."""
    pcm = zi * zi + zq * zq
    s = torch.trunc(torch.sqrt(pcm.to(torch.float64))).to(_I64)
    return _i16(_i16(s) * int(output_scale))


def low_pass_simple_int(x: torch.Tensor, step: int) -> torch.Tensor:
    """Int16-wrapped group sums (rtl_fm.c:373-387; the off-by-one tail
    write is dropped like the float path)."""
    n = (x.shape[0] // step) * step
    return _i16(x[:n].reshape(-1, step).sum(dim=1))


def _ctrunc_div(p: int, q: int) -> int:
    """C ``p / q`` for a positive ``q``."""
    return p // q if p >= 0 else -(-p // q)


def deemph_int_plain(avg: torch.Tensor, x: torch.Tensor, deemph_a: int):
    """The kernel's plain version: the rounding-toward-average integer IIR
    (rtl_fm.c:667-682) walked sample by sample on the host.  ``avg`` 0-d
    and ``x`` (N,) int64; returns ``(avg, y)`` on ``x``'s device."""
    a = int(deemph_a)
    half = a // 2
    carry = int(avg)
    out = []
    for v in x.tolist():
        d = v - carry
        carry += _ctrunc_div(d + half if d > 0 else d - half, a)
        out.append(((carry & 0xFFFF) ^ 0x8000) - 0x8000)
    return (torch.tensor(carry, dtype=_I64, device=x.device),
            torch.tensor(out, dtype=_I64, device=x.device))


def deemph_int(avg: torch.Tensor, x: torch.Tensor, deemph_a: int):
    """The integer de-emphasis: ``(avg, x) -> (avg, y)``, bit-exact.

    Launches ``kernels/csrc/int_deemph.cu`` for a CUDA tensor and counts
    the launch: division by the constants of ``kernels.plan.div_magic``,
    and a walk in the segments of ``kernels.plan.deemph_plan``, each
    finding its starting carry where walks from both ends of the block's
    range meet inside a halo, with an ordered fallback where they do not.
    No host synchronisation: the new average stays on the card.  A CPU
    tensor runs :func:`deemph_int_plain`."""
    if x.device.type == "cpu":
        return deemph_int_plain(avg, x, deemph_a)
    if not 0 < deemph_a < 2 ** 31:
        raise ValueError("deemph_int: deemph_a must be in 1 .. 2**31 - 1")
    p = plan.deemph_plan(x.numel(), deemph_a)
    return _launch_deemph(avg, x, deemph_a, p.seg_len, p.halo)


def _launch_deemph(avg, x, deemph_a: int, seg_len: int, halo: int,
                   fallback: torch.Tensor | None = None):
    """Launch the kernel with segments of ``seg_len`` samples and halos of
    ``halo``; ``fallback``, an optional (2,) int32 tensor on the card,
    receives the segments and samples the ordered fallback walked."""
    if x.device.type != "cuda" or avg.device != x.device:
        raise ValueError("deemph_int: avg and x must be on one CUDA device")
    if x.dtype != _I64 or avg.dtype != _I64 or x.dim() != 1 or avg.dim():
        raise TypeError("deemph_int: expects a 0-d int64 avg and (N,) int64 x")
    if fallback is not None and (fallback.device != x.device
                                 or fallback.dtype != torch.int32
                                 or fallback.shape != (2,)
                                 or not fallback.is_contiguous()):
        raise ValueError("deemph_int: fallback must be a contiguous (2,) "
                         "int32 tensor on x's device")
    magic, shift = plan.div_magic(deemph_a)
    x = x.contiguous()
    y = torch.empty_like(x)
    carry = avg.clone()
    dev = x.device
    with torch.cuda.device(dev):
        err = kernels.lib("int_deemph").rx_int_deemph(
            x.data_ptr(), y.data_ptr(), carry.data_ptr(),
            None if fallback is None else fallback.data_ptr(), x.numel(),
            int(deemph_a), magic, shift, int(seg_len), int(halo),
            kernels.stream_handle(dev))
    kernels.check(err, "deemph_int")
    deemph_int.launches += 1
    return carry, y


deemph_int.launches = 0


def dc_block_audio_int(dc_avg: torch.Tensor, x: torch.Tensor,
                       block_const: int = 9):
    """Truncating block-mean EMA (rtl_fm.c:684-697)."""
    avg = _cdiv(torch.sum(x), x.shape[0])
    avg = _cdiv(avg + dc_avg * block_const, block_const + 1)
    return avg, _i16(x - avg)


def low_pass_real_int(now_lpr, prev_lpr_index, x, fast: int, slow: int):
    """Integer accumulate-and-dump resampler (rtl_fm.c:389-409).

    The emission grid is the float engine's carried-phase grid; window sums
    are exact int64 prefix-sum differences and each emission is the C's
    truncated division by ``fast // slow``.  Returns ``(now_lpr,
    prev_lpr_index, y, n_valid)`` with the float path's capacity."""
    divisor = fast // slow
    g = math.gcd(int(fast), int(slow))
    fr, sr = int(fast) // g, int(slow) // g
    n = x.shape[0]
    cap = n * sr // fr + 2
    dev = x.device
    total = (prev_lpr_index + n * sr) // fr
    csum = torch.cumsum(x, dim=0)
    k = torch.arange(cap, dtype=_I64, device=dev)
    pos = ((k + 1) * fr - prev_lpr_index + sr - 1) // sr - 1
    valid = k < total
    ends = csum[torch.clamp(pos, 0, n - 1)]
    starts = torch.cat([torch.zeros(1, dtype=_I64, device=dev), ends[:-1]])
    w = (ends - starts) + torch.where(k == 0, now_lpr, torch.zeros_like(k))
    y = torch.where(valid, _i16(_cdiv(w, divisor)), torch.zeros_like(w))
    last = torch.clamp((total * fr - prev_lpr_index + sr - 1) // sr - 1,
                       0, n - 1)
    consumed = torch.where(total > 0, csum[last] + now_lpr,
                           torch.zeros_like(now_lpr))
    new_now = csum[-1] + now_lpr - consumed
    new_phase = (prev_lpr_index + n * sr) % fr
    return new_now, new_phase, y, total
