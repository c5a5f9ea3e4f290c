"""Polyphase anti-alias decimator state (``-F <taps>``, ``-E hq``).

Counterpart of :mod:`rx_tools_tpu.ops.polyfir`; only the carried state is
ported so far — it is a field of ``FmState``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PolyFirState(NamedTuple):
    tail: torch.Tensor         # (taps - 1, 2) trailing input samples

    @staticmethod
    def init(n_taps: int, device=None):
        return PolyFirState(torch.zeros((n_taps - 1, 2), dtype=torch.float32,
                                        device=device))
