"""Time-major tail helpers shared by both channelizers.

Counterpart of the time-major helpers in :mod:`rx_tools_tpu.models.pfb`
(``_iir_tmaj``, ``_resample_tmaj_periodic``, ``_resample_tmaj``), kept in
a module of their own so that :mod:`.channelizer` and :mod:`.pfb` both
import them at module level (``pfb`` imports ``channelizer``, and the
mixer's time-major step runs these).  ``pfb`` re-exports them under the
same names.

Arrays are time-major, ``(M, D)``: the channel axis is the minor one, so
every stage reads whole rows.  The emission grid of the resamplers
depends only on the carried phase, ``fast`` and ``slow``; it is built on
the device from the phase tensor, so a step never waits for the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rx_tools_tpu_torch.ops.filters import _f32, _powers, _scan_matrix
from rx_tools_tpu_torch.ops.numeric import device_const
from rx_tools_tpu_torch.ops.resample import (ResampleState, _f32_divisor,
                                             _fill, _periodic_mask, _reduce,
                                             _shared_phase, periodic_frame)


def _iir_tmaj(avg, b, c: float, rows: int = 128):
    """First-order IIR scan along the time (major) axis of ``b`` (M, D),
    ``y[t] = c*y[t-1] + b[t]`` per channel column with ``y[-1] = avg``:
    one batched triangular float32 product per ``rows``-step row block plus
    a small row-carry combine (M %% rows == 0)."""
    m, d = b.shape
    r = m // rows
    dev = b.device
    u = device_const(_scan_matrix, rows, float(c), device=dev)  # c^(t-s)
    s_in = torch.einsum("rsc,st->rtc", b.reshape(r, rows, d), u)
    cl = float(c) ** rows
    es = s_in[:, rows - 1, :]                                  # (R, D) ends
    s = 1
    while s < r:                  # inclusive scan of the row ends, decay cl
        es = es + _f32(cl ** s) * F.pad(es, (0, 0, s, 0))[:r]
        s *= 2
    car = (torch.cat([b.new_zeros((1, d)), es[:-1]], dim=0)
           + device_const(_powers, cl, 0, r, device=dev)[:, None]
           * avg[None, :])                                     # (R, D)
    cvec = device_const(_powers, float(c), 1, rows + 1, device=dev)
    y = (s_in + car[:, None, :] * cvec[None, :, None]).reshape(m, d)
    return y[m - 1, :], y


def _resample_tmaj_periodic(state: ResampleState, x, fast: int, slow: int):
    """Time-major batched resampler via the exact emission periodicity
    (``pos(k + slow) == pos(k) + fast``): one ``(fast+E, slow)`` 0/1 mask
    contracted against extended input frames.  ``x`` (M, D) ->
    ``(state, y (cap, D), n_valid ())``; same grid, divisor and carried
    state as :func:`_resample_tmaj` (window sums associate differently).

    A block that emits nothing carries the incoming ``acc`` on, as the
    cumsum form does (the reference package drops it, ADVICE.md:3)."""
    fast, slow = _reduce(fast, slow)
    m, d = x.shape
    cap = m * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    e = fast // slow + 2                      # lookback rows per frame
    assert e <= fast, (fast, slow)            # a frame looks one frame back
    dev = x.device
    phase0 = _shared_phase(state)
    total = (phase0 + m * slow) // fast

    g_frames = -(-(m + 1) // fast) + 1        # covers cap outputs and edges
    xp = torch.cat([x.new_zeros((e, d)), x,
                    x.new_zeros((g_frames * fast - m, d))], dim=0)
    main = xp[e:].reshape(g_frames, fast, d)
    look = xp[: g_frames * fast].reshape(g_frames, fast, d)[:, :e]
    frames = torch.cat([look, main], dim=1)            # (G, fast+E, D)

    s_mask = _periodic_mask(phase0, fast, slow, e, dev).to(x.dtype)
    yg = s_mask.T @ frames                             # (G, slow, D)
    y = yg.reshape(g_frames * slow, d)[:cap]
    kk = torch.arange(cap, device=dev)[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    y = y + torch.where(kk == 0, 1.0, zero) * state.acc[None, :]
    y = torch.where(kk < total, y * divisor, zero)

    # leftover: the inputs after the last complete window (at most
    # fast // slow + 1 rows, so only the last frame's rows are read)
    tail_rows = min(fast + e, m)
    last_pos = torch.clamp((total * fast - phase0 + slow - 1) // slow - 1,
                           -1, m - 1)
    row_i = torch.arange(tail_rows, device=dev)[:, None] + (m - tail_rows)
    new_acc = torch.sum(x[m - tail_rows:] * (row_i > last_pos).to(x.dtype),
                        dim=0)
    new_acc = torch.where(total > 0, new_acc, new_acc + state.acc)
    return (ResampleState(new_acc.to(torch.float32),
                          _fill((phase0 + m * slow) % fast, d)),
            y, total.to(torch.int32))


def _resample_tmaj(state: ResampleState, x, fast: int, slow: int):
    """Time-major batched resampler: ``x`` (M, D) -> ``y`` (cap, D).

    Prefix sums along time by :func:`_iir_tmaj` with ``c = 1`` (M %% 128
    == 0), window ends by whole-row gathers of the (M, D) accumulator along
    the one shared emission grid.  Same grid, truncated divisor and carried
    state as ``ops.resample.resample_rational_batch``."""
    fast, slow = _reduce(fast, slow)
    m, d = x.shape
    if m * slow + fast >= 2 ** 31:
        raise ValueError("block too large for int32 resampler phase")
    cap = m * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    dev = x.device
    phase0 = _shared_phase(state)

    _, csum = _iir_tmaj(x.new_zeros((d,)), x, 1.0)

    k = torch.arange(cap, device=dev)
    total_emits = (phase0 + m * slow) // fast
    pos = ((k + 1) * fast - phase0 + slow - 1) // slow - 1     # shared
    ends = csum[torch.clamp(pos, 0, m - 1)]                    # (cap, D)
    starts = torch.cat([x.new_zeros((1, d)), ends[:-1]], dim=0)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    y = ((ends - starts)
         + torch.where(k == 0, 1.0, zero)[:, None] * state.acc[None, :])
    y = torch.where((k < total_emits)[:, None], y * divisor, zero)

    total = csum[m - 1, :] + state.acc
    last_pos = torch.clamp(
        (total_emits * fast - phase0 + slow - 1) // slow - 1, 0, m - 1)
    # a 1-element index: a 0-d CUDA index would be read on the host
    last_row = csum.index_select(0, last_pos.reshape(1))[0]
    consumed_end = torch.where(total_emits > 0, last_row + state.acc, zero)
    return (ResampleState((total - consumed_end).to(torch.float32),
                          _fill((phase0 + m * slow) % fast, d)),
            y, total_emits.to(torch.int32))


def resample_tmaj(state: ResampleState, x, fast: int, slow: int):
    """The time-major resampler both channelizers run: the periodic-mask
    form when the reduced frame is small, else the prefix-sum form (the
    reference package's selection, ``pfb.py:384-397``)."""
    fn = (_resample_tmaj_periodic if periodic_frame(fast, slow)
          else _resample_tmaj)
    return fn(state, x, fast, slow)
