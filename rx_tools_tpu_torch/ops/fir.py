"""Decimating FIRs: the reference's three capture decimators and the
post-demod block-sum decimator.

Counterpart of :mod:`rx_tools_tpu.ops.fir`:

- :func:`boxcar_decimate` — accumulate-by-``D`` with a carried partial
  window (``low_pass``, ``src/rtl_fm.c:351-371``); keeps the window *sum*
  (gain ``D``), as the reference does.  The chain's aligned boxcar runs in
  the capture-head kernel (or a reshape-sum behind the raw DC block); this
  carried form is the reference package's op for unaligned streams.
- :func:`fifth_order_decimate` / :func:`fifth_order_cascade` — the
  halfband decimate-by-2 with binomial taps ``(1,5,10,10,5,1)/16``
  (``src/rtl_fm.c:411-440``), cascaded ``passes`` times, 5 carried samples
  per component per pass.
- :func:`droop_fir` — the 9-tap symmetric CIC droop-compensation FIR
  (``generic_fir``, ``src/rtl_fm.c:442-465``); the output at ``n`` is the
  filter over ``x[n-9 .. n-1]`` (the reference's one-sample pre-delay).

All are ``(state, x) -> (state, y)`` over ``(N, 2)`` float32 I/Q blocks,
as strided slices and adds in the reference's term order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch.ops.cic import cic_9_taps

_F5 = (1.0, 5.0, 10.0, 10.0, 5.0, 1.0)          # binomial(5)


class BoxcarState(NamedTuple):
    acc: torch.Tensor        # (2,) partial window sum (now_r, now_j)
    phase: torch.Tensor      # () int32, samples already in window

    @staticmethod
    def init(device=None):
        return BoxcarState(torch.zeros(2, dtype=torch.float32, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))


def boxcar_decimate(state: BoxcarState, x: torch.Tensor, downsample: int):
    """Accumulate-by-``downsample`` with carry.

    Returns ``(state, y, n_valid)`` with ``y`` of fixed capacity
    ``N // downsample + 1``; rows past ``n_valid`` are zero."""
    n = x.shape[0]
    d = int(downsample)
    cap = n // d + 1
    dev = x.device
    csum = torch.cumsum(x, dim=0)                        # (N, 2)
    k = torch.arange(cap, device=dev)
    # emit positions: p_k = (k+1)*D - 1 - phase, valid while p_k < N
    p = (k + 1) * d - 1 - state.phase.to(torch.int64)
    valid = p < n
    ends = csum[torch.clamp(p, 0, n - 1)]
    starts = torch.cat([torch.zeros((1, 2), dtype=x.dtype, device=dev),
                        ends[:-1]])
    y = ends - starts
    y = y + torch.where((k == 0)[:, None], state.acc[None, :],
                        torch.zeros((), dtype=x.dtype, device=dev))
    y = torch.where(valid[:, None], y, torch.zeros_like(y))
    n_valid = valid.to(torch.int32).sum(dtype=torch.int32)
    total = csum[-1] + state.acc if n > 0 else state.acc
    new_acc = total - y.sum(dim=0)
    new_phase = (state.phase + n) % d
    return (BoxcarState(new_acc.to(torch.float32), new_phase.to(torch.int32)),
            y, n_valid)


class FifthOrderState(NamedTuple):
    hist: torch.Tensor       # (passes, 5, 2) trailing samples per pass

    @staticmethod
    def init(passes: int, device=None):
        return FifthOrderState(torch.zeros((passes, 5, 2),
                                           dtype=torch.float32, device=device))


def fifth_order_decimate(hist: torch.Tensor, x: torch.Tensor):
    """One decimate-by-2 pass over ``x' = concat(hist, x)``:
    ``y[k] = (x'[2k] + 5 x'[2k+1] + 10 x'[2k+2] + 10 x'[2k+3] + 5 x'[2k+4]
    + x'[2k+5]) / 16`` — the reference recurrence with its ``>>4`` done in
    float (2x passband gain per pass kept)."""
    n = x.shape[0]
    xp = torch.cat([hist, x], dim=0)                     # (N + 5, 2)
    acc = None
    for t, c in enumerate(_F5):
        term = xp[t: t + n: 2] * c
        acc = term if acc is None else acc + term
    return xp[-5:], acc * (1.0 / 16.0)


def fifth_order_cascade(state: FifthOrderState, x: torch.Tensor,
                        passes: int):
    """``passes`` cascaded halfband stages: N -> N / 2**passes."""
    hists = []
    y = x
    for p in range(passes):
        h, y = fifth_order_decimate(state.hist[p], y)
        hists.append(h)
    return FifthOrderState(torch.stack(hists)), y


class DroopState(NamedTuple):
    hist: torch.Tensor       # (9, 2) trailing samples

    @staticmethod
    def init(device=None):
        return DroopState(torch.zeros((9, 2), dtype=torch.float32,
                                      device=device))


def droop_fir(state: DroopState, x: torch.Tensor, passes: int):
    """CIC droop compensation: 9-tap symmetric FIR over ``x[n-9 .. n-1]``."""
    taps = cic_9_taps(passes)
    n = x.shape[0]
    xp = torch.cat([state.hist, x], dim=0)               # (N + 9, 2)
    acc = None
    for t in range(9):
        term = xp[t: t + n] * float(np.float32(taps[t]))
        acc = term if acc is None else acc + term
    return DroopState(xp[-9:]), acc


def low_pass_simple(x: torch.Tensor, step: int) -> torch.Tensor:
    """Post-demod block-sum decimator (``low_pass_simple``,
    ``src/rtl_fm.c:373-387``).  Keeps the sum (not mean), like the
    reference; its off-by-one tail write (``rtl_fm.c:385``) is dropped."""
    n = (x.shape[0] // step) * step
    return x[:n].reshape(-1, step).sum(dim=1)
