"""Windowed-sinc polyphase decimation (``-F <taps>`` above 9, ``-E hq``).

Counterpart of :mod:`rx_tools_tpu.ops.polyfir`, beyond the reference's
filters: :func:`design_lowpass` builds a Kaiser-windowed sinc (numpy, the
reference's table), :func:`fir_decimate` applies it at stride D,
``y[k] = D * sum_t h[t] x[kD + (T-1) - t]``, with the FIR tail (``T-1``
input samples) carried between blocks.

The decimated output is the product of strided windows (``unfold``, a
view) with the reversed taps, summed elementwise in float32: no
convolution and no matrix product, so neither cuDNN's TF32 default
(``torch.backends.cudnn.allow_tf32``) nor the matmul flag can lower its
precision on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def design_lowpass(n_taps: int, cutoff: float, beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc, unity DC gain; ``cutoff`` normalised to the
    input Nyquist (1.0 == fs/2)."""
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    h *= np.kaiser(n_taps, beta)
    return (h / h.sum()).astype(np.float32)


class PolyFirState(NamedTuple):
    tail: torch.Tensor         # (taps - 1, 2) trailing input samples

    @staticmethod
    def init(n_taps: int, device=None):
        return PolyFirState(torch.zeros((n_taps - 1, 2), dtype=torch.float32,
                                        device=device))


def fir_decimate(state: PolyFirState, x: torch.Tensor, taps: torch.Tensor,
                 downsample: int):
    """Anti-aliased decimate-by-D of ``x`` (N, 2), N % D == 0.

    Returns ``(state, y)`` with ``y`` (N/D, 2); the gain is the reference
    boxcar's (D at DC), so squelch levels and output_scale carry over."""
    d = int(downsample)
    t = taps.shape[0]
    xp = torch.cat([state.tail, x], dim=0)               # (N + T - 1, 2)
    windows = xp.T.unfold(1, t, d)                       # (2, N/D, T) view
    y = (windows * taps.flip(0)).sum(dim=-1).T * float(d)
    return PolyFirState(xp[-(t - 1):]), y
