"""``--int-fft``: the reference's ``fix_fft`` scanner, bit-exact, on int32
tensors.

Counterpart of :mod:`rx_tools_tpu.ops.intfft`.  Every integer quirk of the
C hot loop is reproduced, so the CSV is identical to the reference
binary's:

- ``fix_fft`` (rtl_power.c:264-320): in-place radix-2 DIT int16 FFT,
  unconditional ``>>1`` per stage, ``FIX_MPY`` Q14 rounding with the
  round-half bit, int16 wraparound on every store;
- the window multiply (rtl_power.c:747-758): ``(int16_t)(sample * coef)``
  with the ×256 integer coefficients — wrapping, not saturating;
- ``remove_dc`` (rtl_power.c:609-624): component sum divided (C-truncating)
  by the INTERLEAVED length — the half-DC quirk;
- the boxcar accumulate (rtl_power.c:723-733): int16 wrap per addition
  (== one wrap of the int32 group sum, since wrap is mod-2^16);
- ``|X|^2`` per segment in int32, accumulated exactly into int64 by the
  caller.  It is below 2^31 except for a bin of (-32768, -32768), where
  int32 wraps to -2^31 exactly as in the reference package.

Values travel as int32 tensors holding int16-range numbers; :func:`i16w`
wraps after every C store that could overflow.  ``torch.sum`` of int32
returns int64, so every sum here names its int32 dtype (the guarded
ranges keep it exact), and every division of a possibly negative value
truncates (``rounding_mode="trunc"``).  All butterflies of a stage run as
one vectorised step over ``(..., g, 2, ell)``: about 60 small kernels a
stage on the card.

Semantics oracle: ``tests/oracles/c_ref.py::scanner_segment``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rx_tools_tpu_torch.ops.numeric import device_const

_I32 = torch.int32


def i16w(x: torch.Tensor) -> torch.Tensor:
    """Wrap int32 values to the int16 range (C int16_t store)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _fix_mpy(a, b):
    """``FIX_MPY`` (rtl_power.c:256-262): Q14 multiply, round-half bit."""
    c = (a * b) >> 14
    return i16w((c >> 1) + (c & 1))


def sine_table_np(log2_n_wave: int) -> np.ndarray:
    """int16 3/4-wave sine LUT (``sine_table``, rtl_power.c:240-254)."""
    n_wave = 1 << log2_n_wave
    return np.array([int(round(32767 * math.sin(i * 2.0 * math.pi / n_wave)))
                     for i in range(n_wave * 3 // 4)], np.int32)


def _bitrev_perm(m: int) -> np.ndarray:
    """The bit-reverse reorder of fix_fft's swap loop (rtl_power.c:276-291)."""
    n = 1 << m
    perm = np.arange(n)
    for i in range(n):
        perm[i] = int(f"{i:0{m}b}"[::-1], 2) if m else 0
    return perm


def _twiddle_stage(log2_n_wave: int, s: int) -> np.ndarray:
    """Stage ``s``'s ``(wr, wi)`` rows (2, 2**s) int32 of fix_fft's inner
    loop: ``wr = sinewave[j + N_WAVE/4] >> 1``, ``wi = -sinewave[j] >> 1``
    with ``j = m << k`` and ``k = LOG2_N_WAVE - 1 - s``."""
    sw = sine_table_np(log2_n_wave)
    mm = np.arange(1 << s)
    k = log2_n_wave - 1 - s
    wr = sw[(mm << k) + (1 << log2_n_wave) // 4] >> 1
    wi = i16w(-sw[mm << k]) >> 1
    return np.stack([wr, wi]).astype(np.int32)


def fix_fft_batch(re, im, m: int, log2_n_wave: int | None = None):
    """Batched bit-exact ``fix_fft``: ``re``/``im`` (..., n) int32 in the
    int16 range -> transformed (..., n), scaled by 1/n like the C."""
    if log2_n_wave is None:
        log2_n_wave = m
    n = 1 << m
    assert n <= (1 << log2_n_wave), "fft size exceeds sine table"
    dev = re.device
    perm = device_const(_bitrev_perm, m, device=dev)
    re = re.index_select(-1, perm)
    im = im.index_select(-1, perm)
    lead = re.shape[:-1]
    ell, s = 1, 0
    while ell < n:
        w = device_const(_twiddle_stage, log2_n_wave, s, device=dev)
        wr, wi = w[0], w[1]                                   # (ell,)
        g = n // (2 * ell)
        # (..., g, 2, ell): [..., 0, :] = the `i` points, [..., 1, :] = `j2`
        r4 = re.reshape(*lead, g, 2, ell)
        i4 = im.reshape(*lead, g, 2, ell)
        r_i, r_j = r4[..., 0, :], r4[..., 1, :]
        i_i, i_j = i4[..., 0, :], i4[..., 1, :]
        tr = i16w(_fix_mpy(wr, r_j) - _fix_mpy(wi, i_j))
        ti = i16w(_fix_mpy(wr, i_j) + _fix_mpy(wi, r_j))
        qr = r_i >> 1                      # operands already int16-range
        qi = i_i >> 1
        re = torch.stack([i16w(qr + tr), i16w(qr - tr)], dim=-2) \
            .reshape(*lead, n)
        im = torch.stack([i16w(qi + ti), i16w(qi - ti)], dim=-2) \
            .reshape(*lead, n)
        s += 1
        ell <<= 1
    return re, im


def boxcar_decim_int(x: torch.Tensor, ds: int) -> torch.Tensor:
    """scanner's wrapping boxcar accumulate (rtl_power.c:723-733).

    ``x``: (..., 2*L) interleaved int32; returns (..., 2*L/ds).  The C
    wraps int16 on every addition; mod-2^16 arithmetic is associative, so
    one wrap of the int32 group sum is identical.
    """
    if ds <= 1:
        return x
    lead = x.shape[:-1]
    pairs = x.reshape(*lead, -1, ds, 2)
    return i16w(pairs.sum(dim=-2, dtype=_I32)).reshape(*lead, -1)


def remove_dc_int(x: torch.Tensor) -> torch.Tensor:
    """``remove_dc`` on interleaved blocks (rtl_power.c:609-624): the
    component sum is divided — C truncation — by the INTERLEAVED length
    (the half-DC quirk), then subtracted from that component only.
    Applied to I then Q exactly like the C call pair (rtl_power.c:744-745).

    Valid while ``len * 32768 < 2**31`` (guarded by the caller) so the
    int32 component sum cannot overflow.
    """
    lead = x.shape[:-1]
    ln = x.shape[-1]
    pairs = x.reshape(*lead, -1, 2)

    def one(comp, full_len):
        s = comp.sum(dim=-1, keepdim=True, dtype=_I32)
        ave = i16w(torch.div(s, full_len, rounding_mode="trunc"))
        # the C skips the loop when ave == 0; comp is int16-range, so
        # wrapping comp - 0 gives comp back either way
        return i16w(comp - ave)

    i = one(pairs[..., 0], ln)
    # the C's second call sees (data+1, len-1): sum over the same Q
    # samples, but divided by len-1
    q = one(pairs[..., 1], ln - 1)
    return torch.stack([i, q], dim=-1).reshape(*lead, ln)


def int_hop_segments(block, win_int, bin_e: int, ds: int,
                     peak_hold: bool = False):
    """Hops' reads -> per-segment ``|X|^2`` (..., segs, bin_len) int32,
    every stage bit-faithful (scanner, rtl_power.c:714-770, boxcar path).

    ``block``: (..., buf_len) int16/int32 interleaved CS16 tensor, one row
    a hop.  The caller accumulates the returned powers into int64 (sums
    may not fit int32), or takes their max over segments for peak
    hold.  ``win_int`` is the ×256
    integer coefficient table (rtl_power.c:1034-1037).  ``peak_hold`` is
    the reference's parameter, accepted and not read there either: the
    segments are the same, and the caller chooses sum or max.
    """
    bin_len = 1 << bin_e
    x = block.to(_I32)
    eff = x.shape[-1] // ds
    assert eff * 32768 < 2**31, "interleaved length overflows int32 sums"
    x = boxcar_decim_int(x, ds)[..., :eff]
    x = remove_dc_int(x)
    segs = eff // (2 * bin_len)
    lead = x.shape[:-1]
    x = x[..., : segs * 2 * bin_len].reshape(*lead, segs, bin_len, 2)
    w = torch.as_tensor(win_int).to(device=x.device, dtype=_I32)[:, None]
    x = i16w(x * w)                       # (int16_t)(sample * coef): wraps
    re, im = fix_fft_batch(x[..., 0], x[..., 1], bin_e)
    return re * re + im * im


def rms_power_int(block) -> int:
    """Giant-bin total power (``rms_power``, rtl_power.c:403-429), host
    side, exact: int64 sums, the C's float DC correction with round()."""
    b = np.asarray(block, np.int64)
    t = int(b.sum())
    p = int((b * b).sum())
    dc = float(t) / b.size
    err = t * 2 * dc - dc * dc * b.size
    return p - int(round(err))
