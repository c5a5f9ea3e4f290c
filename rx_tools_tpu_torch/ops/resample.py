"""Rational audio resampler (fast -> slow), ``low_pass_real`` re-designed.

Counterpart of :mod:`rx_tools_tpu.ops.resample`.  The reference
(``src/rtl_fm.c:389-409``) accumulates samples and emits one averaged
output every time a fractional phase (``prev_lpr_index += slow``) crosses
``fast``, dividing by the *truncated* ratio ``fast // slow`` — e.g.
170 kHz -> 32 kHz emits alternating 5- and 6-sample windows, all divided
by 5.  Output length is data-dependent, so a call returns a fixed-capacity
output plus a valid count.  The emission grid, the carried phase and the
counts are exact integer arithmetic; the phase must fit int32, as in the
reference (the guard below).

Two float formulations, as in the reference:

- the cumsum path (the CPU default): one inclusive prefix sum of the
  block, window sums as differences of gathered prefix values;
- the rows path (:func:`_resample_rows`, the CUDA default): row-local
  prefix sums ``x.reshape(R, 128) @ U`` (one triangular float32 matmul),
  every window a difference of two lanes of one extended row.  Its batched
  twin :func:`resample_rows_blocks` runs M per-block calls as one and
  gives the same values as the loop.

:func:`resample_divisible` is the exact-ratio path (window = divisor =
fast / slow).  :func:`resample_sinc` is the polyphase windowed-sinc resampler of
``-E hq`` (beyond the reference).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.ops.filters import _scan_matrix
from rx_tools_tpu_torch.ops.numeric import device_const


class SincResampleState(NamedTuple):
    """Carry for :func:`resample_sinc`: FIR tail + exact rational phase."""
    tail: torch.Tensor     # (T,) trailing input samples
    num: torch.Tensor      # () int32 phase numerator (units of 1/slow input)

    @staticmethod
    def init(taps: int, device=None):
        return SincResampleState(
            torch.zeros((taps,), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _sinc_phase_lut(taps: int, phases: int, cutoff: float) -> np.ndarray:
    """(phases, taps) windowed-sinc interpolation weights, unity gain."""
    w = np.empty((phases, taps), np.float32)
    center = (taps - 1) / 2.0
    for p in range(phases):
        frac = p / phases
        t = np.arange(taps) - center - frac
        h = np.sinc(cutoff * t) * cutoff * np.kaiser(taps, 8.6)
        w[p] = h / h.sum()
    return w


def resample_sinc(state: SincResampleState, x: torch.Tensor, fast: int,
                  slow: int, taps: int = 16, phases: int = 128):
    """Polyphase windowed-sinc resampler (``-E hq``), beyond the reference.

    Output ``k`` sits at input position ``(num0 + k*fast) / slow``: the
    integer part picks a ``taps``-wide window of ``concat(tail, x)``, the
    fraction one of ``phases`` Kaiser-sinc weight rows.  The phase is exact
    integer arithmetic (the reference package's int32 guard kept).
    Returns ``(state, y, n_valid)`` with :func:`resample_rational`'s
    capacity convention; unity gain."""
    g = math.gcd(int(fast), int(slow))
    fast, slow = int(fast) // g, int(slow) // g
    n = x.shape[0]
    cap = n * slow // fast + 2
    if cap * fast + slow >= 2 ** 31:
        raise ValueError("block too large for int32 resampler phase")
    dev = x.device
    lut = device_const(_sinc_phase_lut, int(taps), int(phases),
                       min(1.0, slow / fast), device=dev)
    xp = torch.cat([state.tail, x])                     # (T + N,)
    k = torch.arange(cap, device=dev)
    num = state.num.to(torch.int64) + k * fast          # position * slow
    idx = num // slow                                   # input index
    ph = ((num - idx * slow) * phases) // slow
    valid = idx + taps - 1 < xp.shape[0]
    idxc = torch.clamp(idx, 0, xp.shape[0] - taps)
    windows = xp[idxc[:, None] + torch.arange(taps, device=dev)[None, :]]
    y = (windows * lut[ph]).sum(dim=1)
    y = torch.where(valid, y, torch.zeros_like(y))
    n_valid = valid.to(torch.int32).sum(dtype=torch.int32)
    new_num = state.num + n_valid * fast - n * slow
    return (SincResampleState(xp[-taps:], new_num.to(torch.int32)),
            y, n_valid)


class ResampleState(NamedTuple):
    acc: torch.Tensor      # () float32 pending window sum   (now_lpr)
    phase: torch.Tensor    # () int32 fractional phase       (prev_lpr_index)

    @staticmethod
    def init(device=None):
        return ResampleState(
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


# test hook: force the rows path on the CPU as well
_ROWS_FORCE = False


def _reduce(fast: int, slow: int):
    g = math.gcd(int(fast), int(slow))
    return int(fast) // g, int(slow) // g


def rows_path_eligible(n: int, fast: int, slow: int,
                       device=None) -> bool:
    """True when :func:`resample_rational` takes the rows path for a block
    of ``n`` samples on ``device`` (default: the resolved device,
    ``device.resolve_device``; callers that batch per-block calls — the
    scan engine's tail — gate on this)."""
    f, s = _reduce(fast, slow)
    if not (_ROWS_FORCE or resolve_device(device).type == "cuda"):
        return False
    return n % 128 == 0 and f // s + 1 <= 16


def _f32_divisor(fast: int, slow: int) -> float:
    return float(np.float32(1.0 / (fast // slow)))


def resample_divisible(x: torch.Tensor, fast: int, slow: int):
    """Exact-ratio path: windows of ``fast // slow`` samples, each sum
    times the float32 ``1 / (fast // slow)``; a trailing partial window is
    dropped.  ``fast`` must be a multiple of ``slow``."""
    if fast % slow:
        raise ValueError(f"resample_divisible: {fast} is not a multiple of "
                         f"{slow}")
    k = fast // slow
    n = (x.shape[0] // k) * k
    return x[:n].reshape(-1, k).sum(dim=1) * _f32_divisor(fast, slow)


def _resample_rows(state: ResampleState, x: torch.Tensor, fast: int,
                   slow: int):
    """Row-local prefix sums + per-row window extraction (``fast``/``slow``
    already reduced, ``fast > slow``, ``n % 128 == 0``).

    1. ``S = x.reshape(R, 128) @ U``: row-local inclusive prefix sums;
    2. each row is extended with the tail of the previous row (negative
       lanes), so any emission window — row-crossing ones included — is a
       difference of two lanes of ONE row;
    3. window sums in (row, slot) layout: ``w[r, e]`` = window of emission
       ``K0[r] + e`` (slot validity zeroes ghosts);
    4. each valid slot lands on its emission index in the flat output.

    Same emission grid, truncated divisor and carried state as the cumsum
    path; values differ only by float32 summation association.
    """
    n = x.shape[0]
    ll = 128
    r = n // ll
    w_max = fast // slow + 1
    ext = w_max + 2
    e_slots = (ll * slow) // fast + 2
    cap = n * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    dev = x.device
    phase = state.phase.to(torch.int64)

    s = x.reshape(r, ll) @ device_const(_scan_matrix, ll, 1.0, device=dev)
    rowtot = s[:, -1]                                       # (R,)
    prev_tail = s[:-1, ll - ext:] - rowtot[:-1, None]
    prev_tail = torch.cat(
        [torch.zeros((1, ext), dtype=s.dtype, device=dev), prev_tail], dim=0)
    csumext = torch.cat([prev_tail, s], dim=1)              # (R, L+EXT)

    # --- stage 3: window sums in (row, slot) layout ---------------------
    ri = torch.arange(r, device=dev)[:, None]
    ei = torch.arange(e_slots, device=dev)[None, :]
    k0 = (phase + (ll * ri) * slow) // fast
    k0n = (phase + (ll * (ri + 1)) * slow) // fast
    k_re = k0 + ei                                          # (R, E)
    total = (phase + n * slow) // fast
    pos = ((k_re + 1) * fast - phase + slow - 1) // slow - 1
    pos_prev = (k_re * fast - phase + slow - 1) // slow - 1
    valid = (ei < (k0n - k0)) & (k_re < total)
    width = ll + ext
    el = torch.clamp(pos - ll * ri + ext, 0, width - 1)
    sl = torch.clamp(pos_prev - ll * ri + ext, 0, width - 1)
    w = torch.where(valid, csumext.gather(1, el) - csumext.gather(1, sl),
                    torch.zeros((), dtype=s.dtype, device=dev))

    # --- stage 4: each valid slot to its emission index -----------------
    y = torch.zeros(cap + 1, dtype=s.dtype, device=dev)
    y.scatter_(0, torch.where(valid, k_re, cap).reshape(-1), w.reshape(-1))
    y = y[:cap]
    kk = torch.arange(cap, device=dev)
    y = y + torch.where(kk == 0, state.acc, torch.zeros_like(state.acc))
    y = torch.where(kk < total, y * divisor, torch.zeros_like(y))

    # --- carried state --------------------------------------------------
    carry_excl = torch.cumsum(rowtot, dim=0) - rowtot
    total_x = carry_excl[-1] + rowtot[-1]
    pos_last = torch.clamp((total * fast - phase + slow - 1) // slow - 1,
                           0, n - 1)
    csum_last = s.reshape(-1)[pos_last] + carry_excl[pos_last // ll]
    consumed_end = torch.where(total > 0, csum_last + state.acc,
                               torch.zeros_like(state.acc))
    new_acc = total_x + state.acc - consumed_end
    new_phase = (phase + n * slow) % fast
    return (ResampleState(new_acc.to(torch.float32),
                          new_phase.to(torch.int32)),
            y, total.to(torch.int32))


def resample_rows_blocks(state: ResampleState, x: torch.Tensor, fast: int,
                         slow: int):
    """``M`` sequential per-block :func:`_resample_rows` calls as one:
    ``x`` (M, N) -> ``(state, y (M, cap), n_valid (M,))``.

    The per-block phase chain is exact integer arithmetic, and the acc
    chain is M scalar float32 steps fed by batched reductions that keep the
    per-block operation order; every array stage runs batched over a
    leading block axis.  Gate callers on :func:`rows_path_eligible`."""
    fast, slow = _reduce(fast, slow)
    mblk, n = x.shape
    ll = 128
    r = n // ll
    w_max = fast // slow + 1
    ext = w_max + 2
    e_slots = (ll * slow) // fast + 2
    cap = n * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    if (mblk * n) * slow + fast >= 2 ** 31:
        raise ValueError("chunk too large for the int32 phase chain")
    dev = x.device

    phs = [state.phase.to(torch.int64)]
    for _ in range(1, mblk):
        phs.append((phs[-1] + n * slow) % fast)
    phase = torch.stack(phs)                                # (M,)
    phb = phase[:, None, None]

    s = (x.reshape(mblk * r, ll)
         @ device_const(_scan_matrix, ll, 1.0, device=dev))
    s3 = s.reshape(mblk, r, ll)
    rowtot = s3[:, :, -1]                                   # (M, R)
    prev_tail = s3[:, :-1, ll - ext:] - rowtot[:, :-1, None]
    prev_tail = torch.cat(
        [torch.zeros((mblk, 1, ext), dtype=s.dtype, device=dev), prev_tail],
        dim=1)
    csumext = torch.cat([prev_tail, s3], dim=2)             # (M, R, L+EXT)

    ri = torch.arange(r, device=dev)[None, :, None]
    ei = torch.arange(e_slots, device=dev)[None, None, :]
    k0 = (phb + (ll * ri) * slow) // fast
    k0n = (phb + (ll * (ri + 1)) * slow) // fast
    k_re = k0 + ei                                          # (M, R, E)
    total = (phase + n * slow) // fast                      # (M,)
    pos = ((k_re + 1) * fast - phb + slow - 1) // slow - 1
    pos_prev = (k_re * fast - phb + slow - 1) // slow - 1
    valid = (ei < (k0n - k0)) & (k_re < total[:, None, None])
    width = ll + ext
    el = torch.clamp(pos - ll * ri + ext, 0, width - 1)
    sl = torch.clamp(pos_prev - ll * ri + ext, 0, width - 1)
    w = torch.where(valid, csumext.gather(2, el) - csumext.gather(2, sl),
                    torch.zeros((), dtype=s.dtype, device=dev))

    y = torch.zeros((mblk, cap + 1), dtype=s.dtype, device=dev)
    y.scatter_(1, torch.where(valid, k_re, cap).reshape(mblk, -1),
               w.reshape(mblk, -1))
    y = y[:, :cap]
    kk = torch.arange(cap, device=dev)[None, :]

    # --- the M-step scalar acc chain (exact per-block op order) ---------
    carry_excl = torch.cumsum(rowtot, dim=1) - rowtot       # (M, R)
    total_x = carry_excl[:, -1] + rowtot[:, -1]
    pos_last = torch.clamp((total * fast - phase + slow - 1) // slow - 1,
                           0, n - 1)
    csum_last = (s3.reshape(mblk, r * ll).gather(1, pos_last[:, None])[:, 0]
                 + carry_excl.gather(1, (pos_last // ll)[:, None])[:, 0])
    zero = torch.zeros_like(state.acc)
    accs = [state.acc]
    for i in range(mblk):
        consumed_end = torch.where(total[i] > 0, csum_last[i] + accs[i], zero)
        accs.append(total_x[i] + accs[i] - consumed_end)
    acc_vec = torch.stack(accs[:-1])                        # (M,) starts
    y = y + torch.where(kk == 0, acc_vec[:, None], zero)
    y = torch.where(kk < total[:, None], y * divisor, torch.zeros_like(y))
    final_phase = (phase[mblk - 1] + n * slow) % fast
    return (ResampleState(accs[-1].to(torch.float32),
                          final_phase.to(torch.int32)),
            y, total.to(torch.int32))


def resample_rational(state: ResampleState, x: torch.Tensor, fast: int,
                      slow: int):
    """General carried-phase resampler.

    Returns ``(state, y, n_valid)``; ``y`` has static capacity
    ``N*slow//fast + 2`` and entries past ``n_valid`` are zero.  The
    divisor is the truncated ``fast // slow``, matching the reference.
    """
    if fast < slow:
        # the reference's low_pass_real is strictly fast->slow; its C would
        # divide by zero here — fail loudly instead
        raise ValueError(
            f"resample target {slow} exceeds input rate {fast}: "
            "low_pass_real only downsamples (use -r below -s)")
    n = x.shape[0]
    if n * _reduce(fast, slow)[1] + fast >= 2 ** 31:
        # the cumulative phase n*slow must fit int32, as in the reference
        raise ValueError(
            f"block of {n} samples overflows the int32 resampler phase for "
            f"ratio {fast}/{slow}; split the stream into smaller chunks")
    cap = n * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    fast, slow = _reduce(fast, slow)
    dev = x.device
    if rows_path_eligible(n, fast, slow, dev):
        return _resample_rows(state, x, fast, slow)
    phase = state.phase.to(torch.int64)
    csum = torch.cumsum(x, dim=0)
    k = torch.arange(cap, device=dev)
    total_emits = (phase + n * slow) // fast
    # position of the k-th emit: smallest j with phase + j*slow >= (k+1)*fast
    pos = ((k + 1) * fast - phase + slow - 1) // slow - 1
    valid = k < total_emits
    ends = csum[torch.clamp(pos, 0, n - 1)]
    starts = torch.cat([torch.zeros(1, dtype=x.dtype, device=dev), ends[:-1]])
    zero = torch.zeros_like(state.acc)
    y = (ends - starts) + torch.where(k == 0, state.acc, zero)
    y = torch.where(valid, y * divisor, torch.zeros_like(y))
    n_valid = valid.to(torch.int32).sum(dtype=torch.int32)
    total = csum[-1] + state.acc
    last = torch.clamp((total_emits * fast - phase + slow - 1) // slow - 1,
                       0, n - 1)
    consumed_end = torch.where(total_emits > 0, csum[last] + state.acc, zero)
    new_acc = total - consumed_end
    new_phase = (phase + n * slow) % fast
    return (ResampleState(new_acc.to(torch.float32),
                          new_phase.to(torch.int32)),
            y, n_valid)


def periodic_eligible(fast: int, slow: int, device: torch.device) -> bool:
    """True when :func:`resample_rational_batch` on ``device`` takes the
    periodic-mask form (:func:`_resample_cm_periodic`): on the card, when
    the reduced frame is small (the CPU keeps the prefix-sum form, as the
    reference package does off its accelerator)."""
    return torch.device(device).type == "cuda" and periodic_frame(fast, slow)


def periodic_frame(fast: int, slow: int) -> bool:
    """True when the reduced ratio's frame is small enough for the
    periodic-mask resamplers: ``fast + E <= 512`` and ``E <= fast`` for
    ``E = fast // slow + 2`` lookback rows (the reference's gate)."""
    f, s = _reduce(fast, slow)
    e = f // s + 2
    return f + e <= 512 and e <= f


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 inclusive sum along the last (short) axis."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def prefix_sum16(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in the order of the
    reference's CPU cumsum (XLA's blocked rewrite of a long
    ``reduce_window``): sequential float32 sums inside rows of 16, the row
    totals scanned the same way, recursively, each row plus its carry.
    Bit for bit the reference's on every device (``torch.cumsum``
    accumulates in double on the CPU and in a parallel order on CUDA)."""
    n = x.shape[-1]
    if n <= base:
        return _running_sum(x)
    lead = x.shape[:-1]
    r = -(-n // base)
    rows = F.pad(x, (0, r * base - n)).reshape(*lead, r, base)
    within = _running_sum(rows)
    carry = prefix_sum16(within[..., -1], base)
    carry = torch.cat([carry.new_zeros((*lead, 1)), carry[..., :-1]], dim=-1)
    return (within + carry[..., None]).reshape(*lead, r * base)[..., :n]


def _shared_phase(state: ResampleState) -> torch.Tensor:
    """The channels' common carried phase (element 0), as int64."""
    return state.phase[0].to(torch.int64)


def _fill(value: torch.Tensor, n: int) -> torch.Tensor:
    """A 0-dim tensor repeated ``n`` times, as int32."""
    return value.to(torch.int32).expand(n).contiguous()


def _resample_cm_periodic(state: ResampleState, x: torch.Tensor, fast: int,
                          slow: int):
    """Channel-major batched resampler via the exact emission periodicity
    ``pos(k + slow) == pos(k) + fast``: every ``fast``-input frame emits
    ``slow`` outputs with the same window pattern, so the whole resampler
    is one ``(fast+E, slow)`` 0/1 mask (built from the carried phase, on
    the device) contracted against extended input frames.  ``x`` (C, M) ->
    ``(state, y (C, cap), n_valid ())``; same emission grid, divisor and
    carried state as :func:`resample_rational_batch` (window sums
    associate differently).

    A block that emits nothing carries the incoming ``acc`` on, as the
    cumsum form does (the reference package's periodic form drops it,
    ADVICE.md:3)."""
    fast, slow = _reduce(fast, slow)
    c_ch, m = x.shape
    cap = m * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    e = fast // slow + 2                       # lookback rows per frame
    assert e <= fast, (fast, slow)
    dev = x.device
    phase0 = _shared_phase(state)
    total = (phase0 + m * slow) // fast

    g_frames = -(-(m + 1) // fast) + 1
    xp = torch.cat([x.new_zeros((c_ch, e)), x,
                    x.new_zeros((c_ch, g_frames * fast - m))], dim=1)
    main = xp[:, e:].reshape(c_ch, g_frames, fast)
    look = xp[:, : g_frames * fast].reshape(c_ch, g_frames, fast)[:, :, :e]
    frames = torch.cat([look, main], dim=2)            # (C, G, fast+E)

    s_mask = _periodic_mask(phase0, fast, slow, e, dev).to(x.dtype)
    y = (frames @ s_mask).reshape(c_ch, g_frames * slow)[:, :cap]
    kk = torch.arange(cap, device=dev)[None, :]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    y = y + torch.where(kk == 0, 1.0, zero) * state.acc[:, None]
    y = torch.where(kk < total, y * divisor, zero)

    tail_cols = min(fast + e, m)
    last_pos = torch.clamp((total * fast - phase0 + slow - 1) // slow - 1,
                           -1, m - 1)
    col_i = torch.arange(tail_cols, device=dev)[None, :] + (m - tail_cols)
    new_acc = torch.sum(x[:, m - tail_cols:]
                        * (col_i > last_pos).to(x.dtype), dim=1)
    new_acc = torch.where(total > 0, new_acc, new_acc + state.acc)
    return (ResampleState(new_acc.to(torch.float32),
                          _fill((phase0 + m * slow) % fast, c_ch)),
            y, total.to(torch.int32))


def _periodic_mask(phase0: torch.Tensor, fast: int, slow: int, e: int,
                   dev: torch.device) -> torch.Tensor:
    """(fast+E, slow) bool: input ``i - E`` of a frame feeds its output
    ``j``, for the carried phase ``phase0`` (output j of a frame consumes
    inputs ``(pos(j-1), pos(j)]``)."""
    j = torch.arange(slow, device=dev)
    posj = ((j + 1) * fast - phase0 + slow - 1) // slow - 1
    posjp = (j * fast - phase0 + slow - 1) // slow - 1
    i_rel = torch.arange(fast + e, device=dev)[:, None] - e
    return (i_rel > posjp[None, :]) & (i_rel <= posj[None, :])


def resample_rational_batch(state: ResampleState, x: torch.Tensor, fast: int,
                            slow: int):
    """Batched :func:`resample_rational` over a channel axis: ``x`` (C, N).

    The prefix sums are :func:`prefix_sum16` (the reference's association,
    so this form equals the reference's bit for bit).  Every channel of a channelizer consumes equal-length blocks, so all
    share one (data-independent) emission grid: positions and masks are
    computed once, on the device from the carried phase (no host sync),
    and the window ends are gathered along that one index vector.
    ``state.acc`` (C,) per-channel leftovers; ``state.phase`` (C,) int32,
    identical by construction (element 0 is used).  Returns
    ``(state, y (C, cap), n_valid ())``."""
    if fast < slow:
        raise ValueError(
            f"resample target {slow} exceeds input rate {fast}: "
            "low_pass_real only downsamples (use -r below -s)")
    c_ch, n = x.shape
    if n * _reduce(fast, slow)[1] + fast >= 2 ** 31:
        raise ValueError(
            f"block of {n} samples overflows the int32 resampler phase for "
            f"ratio {fast}/{slow}; split the stream into smaller chunks")
    if periodic_eligible(fast, slow, x.device):
        return _resample_cm_periodic(state, x, fast, slow)
    cap = n * slow // fast + 2
    divisor = _f32_divisor(fast, slow)
    fast, slow = _reduce(fast, slow)
    dev = x.device
    phase0 = _shared_phase(state)

    k = torch.arange(cap, device=dev)
    total_emits = (phase0 + n * slow) // fast
    pos = ((k + 1) * fast - phase0 + slow - 1) // slow - 1   # shared
    valid = k < total_emits
    csum = prefix_sum16(x)                                  # (C, N)
    ends = csum[:, torch.clamp(pos, 0, n - 1)]              # (C, cap)
    starts = torch.cat([x.new_zeros((c_ch, 1)), ends[:, :-1]], dim=1)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    y = ((ends - starts)
         + torch.where(k == 0, 1.0, zero)[None, :] * state.acc[:, None])
    y = torch.where(valid[None, :], y * divisor, zero)

    total = csum[:, -1] + state.acc
    last = torch.clamp((total_emits * fast - phase0 + slow - 1) // slow - 1,
                       0, n - 1)
    consumed_end = torch.where(total_emits > 0, csum[:, last] + state.acc,
                               zero)
    return (ResampleState((total - consumed_end).to(torch.float32),
                          _fill((phase0 + n * slow) % fast, c_ch)),
            y, total_emits.to(torch.int32))
