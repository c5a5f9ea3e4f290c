"""Windowed power-spectrum ops (the rx_power compute path) on tensors.

Counterpart of :mod:`rx_tools_tpu.ops.spectrum`.  The reference's per-hop
hot loop (``scanner``, ``src/rtl_power.c:670-772``) windows each
``bin_len`` segment with int coefficients, runs a fixed-point radix-2 FFT
with an unconditional ``>>1`` per stage (net ``1/n`` scaling) and
accumulates ``|X|^2`` into int64 bins.  Here, as in the reference package:

- all segments (and all hops, in :mod:`models.powerscan`) batch into one
  complex64 FFT over the bin axis (``torch.fft.fft``: cuFFT on the card);
- an explicit ``1/n`` matches fix_fft's scaling, and ``|X|^2`` is scaled by
  ``2^16`` so accumulator units match the reference's (its int window
  coefficients carry a ×256 gain, ``rtl_power.c:1036``);
- input is expected in the ±128 "8-bit" float range.

Every op takes leading batch axes.  The CSV-side quirks of ``csv_dbm``
(``rtl_power.c:774-817``) are :func:`fftshift_quirks` / :func:`power_to_dbm`.
"""

from __future__ import annotations

import numpy as np
import torch

#: |X_int|^2 / |X_float|^2 for the reference's ×256 integer window coefs
COEF_GAIN_SQ = 65536.0


def remove_dc(x: torch.Tensor) -> torch.Tensor:
    """Per-component mean removal (``remove_dc``, rtl_power.c:609-624) over
    the sample axis of ``(..., N, 2)``."""
    return x - x.mean(dim=-2, keepdim=True)


def segmented_power_spectrum(x, win, avg, samples, downsample: int,
                             peak_hold: bool = False):
    """Window + batched FFT + |X|^2 accumulate.

    ``x``: (..., n_segments, bin_len, 2) float32 I/Q in the ±128 range
    (already decimated).  ``win``: (bin_len,) float32 window.  ``avg``:
    (..., bin_len) accumulator carried across integration intervals;
    ``samples``: (...) int32 counter (the reference counts ``+= downsample``
    per segment, rtl_power.c:769).  Returns ``(avg, samples)`` updated.
    """
    z = torch.complex(x[..., 0], x[..., 1])
    n = x.shape[-2]
    X = torch.fft.fft(z * win, dim=-1) * (1.0 / n)
    p = (X.real ** 2 + X.imag ** 2) * COEF_GAIN_SQ
    if peak_hold:
        avg = torch.maximum(avg, p.amax(dim=-2))
    else:
        avg = avg + p.sum(dim=-2)
    return avg, samples + x.shape[-3] * downsample


def total_power(x: torch.Tensor) -> torch.Tensor:
    """Giant-bin (bin_e == 0) path: pooled sum of squares with DC
    correction (``rms_power``, rtl_power.c:403-429).  ``x``: (..., N, 2)
    -> (...)."""
    v = x.reshape(*x.shape[:-2], -1)
    n = v.shape[-1]
    t = v.sum(dim=-1)
    p = (v * v).sum(dim=-1)
    dc = t / n
    err = t * 2.0 * dc - dc * dc * n
    return p - err


def fftshift_quirks(avg):
    """csv_dbm pre-output fixups (rtl_power.c:782-791) on a 1-D tensor or
    array: nuke the DC bin by copying bin 1, then rotate by N/2 (the FFT
    "translated by 180°")."""
    half = avg.shape[0] // 2
    if isinstance(avg, torch.Tensor):
        avg = avg.clone()
        avg[0] = avg[1]
        return torch.cat([avg[half:], avg[:half]])
    avg = np.array(avg)
    avg[0] = avg[1]
    return np.concatenate([avg[half:], avg[:half]])


def power_to_dbm(avg, rate: float, samples: int):
    """``10*log10(avg / rate / samples)`` (rtl_power.c:800-806)."""
    xp = torch if isinstance(avg, torch.Tensor) else np
    return 10.0 * xp.log10(avg / rate / max(int(samples), 1))
