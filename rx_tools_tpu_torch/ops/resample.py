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

:func:`resample_sinc` is the polyphase windowed-sinc resampler of
``-E hq`` (beyond the reference).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

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
                       device: torch.device) -> bool:
    """True when :func:`resample_rational` takes the rows path for a block
    of ``n`` samples on ``device`` (callers that batch per-block calls —
    the scan engine's tail — gate on this)."""
    f, s = _reduce(fast, slow)
    if not (_ROWS_FORCE or torch.device(device).type == "cuda"):
        return False
    return n % 128 == 0 and f // s + 1 <= 16


def _f32_divisor(fast: int, slow: int) -> float:
    return float(np.float32(1.0 / (fast // slow)))


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
