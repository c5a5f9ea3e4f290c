"""Decimating FIR states and the post-demod block-sum decimator.

Counterpart of :mod:`rx_tools_tpu.ops.fir`.  The rx_fm WBFM chain
decimates with the aligned boxcar inside the capture head, so of the
reference's three capture decimators only their carried states are here
(the ``FmState`` fields, with the reference's shapes);
the fifth-order cascade and the droop FIR (``-F``) are not yet ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BoxcarState(NamedTuple):
    acc: torch.Tensor        # (2,) partial window sum (now_r, now_j)
    phase: torch.Tensor      # () int32, samples already in window

    @staticmethod
    def init(device=None):
        return BoxcarState(torch.zeros(2, dtype=torch.float32, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))


class FifthOrderState(NamedTuple):
    hist: torch.Tensor       # (passes, 5, 2) trailing samples per pass

    @staticmethod
    def init(passes: int, device=None):
        return FifthOrderState(torch.zeros((passes, 5, 2),
                                           dtype=torch.float32, device=device))


class DroopState(NamedTuple):
    hist: torch.Tensor       # (9, 2) trailing samples

    @staticmethod
    def init(device=None):
        return DroopState(torch.zeros((9, 2), dtype=torch.float32,
                                      device=device))


def low_pass_simple(x: torch.Tensor, step: int) -> torch.Tensor:
    """Post-demod block-sum decimator (``low_pass_simple``,
    ``src/rtl_fm.c:373-387``).  Keeps the sum (not mean), like the
    reference; its off-by-one tail write (``rtl_fm.c:385``) is dropped."""
    n = (x.shape[0] // step) * step
    return x[:n].reshape(-1, step).sum(dim=1)
