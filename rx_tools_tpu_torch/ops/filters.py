"""Scalar stream filters: de-emphasis IIR, audio DC block, squelch RMS.

Counterpart of :mod:`rx_tools_tpu.ops.filters`.

- :func:`deemph_filter` — the FM de-emphasis one-pole IIR
  (``deemph_filter``, ``src/rtl_fm.c:667-682``): the linear recurrence
  ``y[n] = (1-1/a) y[n-1] + x[n]/a`` with ``a`` from :func:`deemph_alpha`
  (``rtl_fm.c:1410-1415``), evaluated in parallel.  Two forms, as in the
  reference: the blocked Hillis-Steele scan (:func:`_iir_scan_flat`, the
  CPU form) and one triangular float32 matrix product per 128-sample row
  plus a row-carry scan (:func:`_iir_scan_flat_mxu`, the CUDA form —
  one pass over the data instead of log2(block) passes).  A (C, M)
  channel stack scans along its minor axis in the same two forms
  (:func:`_iir_scan_batch_mxu` on the card when M %% 128 == 0).
- :func:`dc_block_audio` — block-mean DC removal with exponential
  smoothing across blocks (``rtl_fm.c:684-697``); :func:`dc_block_raw`
  is its twin on raw I/Q before demodulation (``rtl_fm.c:699-721``).
- :func:`rms_level` / :func:`rms_level_planar` — the squelch power
  estimator with DC-in-squares correction (``rms``, ``rtl_fm.c:739-757``),
  over an interleaved block or planar streams; :func:`mad_level` — the mean
  absolute deviation the reference ships beside it (``mad``,
  ``rtl_fm.c:722-737``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.ops.numeric import device_const, div_const


def deemph_alpha(rate_out: int, time_constant_us: int) -> int:
    """``deemph_a`` from the -c time constant (us=75, eu=50); rtl_fm.c:1412."""
    tc = time_constant_us * 1e-6
    return int(round(1.0 / (1.0 - math.exp(-1.0 / (rate_out * tc)))))


def _f32(v: float) -> float:
    """``v`` rounded to float32 (kept as an exact Python float)."""
    return float(np.float32(v))


def _iir_row_scan(b: torch.Tensor, c: float) -> torch.Tensor:
    """Inclusive first-order scan along the minor axis with CONSTANT decay:
    ``S[..., l] = c*S[..., l-1] + b[..., l]`` via Hillis-Steele shifted
    adds (each doubling level needs only the scalar ``c**s``)."""
    ll = b.shape[-1]
    s = 1
    while s < ll:
        b = b + _f32(c ** s) * F.pad(b, (s, 0))[..., :ll]
        s *= 2
    return b


@functools.lru_cache(maxsize=16)
def _scan_matrix(lanes: int, c: float) -> np.ndarray:
    """(lanes, lanes) upper-triangular decay matrix: U[m, l] = c**(l-m)
    for l >= m.  ``b_row @ U`` is the inclusive first-order scan
    ``S[l] = sum_{m<=l} c**(l-m) b[m]`` along the row."""
    i = np.arange(lanes)
    e = i[None, :] - i[:, None]
    return np.where(e >= 0, np.float64(c) ** np.maximum(e, 0),
                    0.0).astype(np.float32)


def _powers(base: float, start: int, stop: int) -> np.ndarray:
    """``base ** arange(start, stop)`` in float64, rounded to float32."""
    return (np.float64(base) ** np.arange(start, stop)).astype(np.float32)


def _iir_scan_flat_mxu(avg, b, c: float, lanes: int = 128):
    """``y[n] = c*y[n-1] + b[n]`` (y[-1] = avg) over a flat stream, via a
    triangular float32 matmul per ``lanes``-sample row plus a tiny
    row-carry scan."""
    k = b.shape[0]
    r = -(-k // lanes)
    dev = b.device
    bp = F.pad(b, (0, r * lanes - k)).reshape(r, lanes)
    s_in = bp @ device_const(_scan_matrix, lanes, float(c), device=dev)
    cl = float(c) ** lanes
    ends_scan = _iir_row_scan(s_in[:, -1], cl)                # (r,) inclusive
    car = (torch.cat([torch.zeros(1, dtype=b.dtype, device=dev),
                      ends_scan[:-1]])
           + device_const(_powers, cl, 0, r, device=dev) * avg)
    cvec = device_const(_powers, float(c), 1, lanes + 1, device=dev)
    y = (s_in + car[:, None] * cvec[None, :]).reshape(-1)[:k]
    return y[-1], y


def _iir_scan_flat(avg, b, c: float, block: int = 512):
    """``y[n] = c*y[n-1] + b[n]`` (y[-1] = avg) over a flat stream, as a
    two-level blocked scan: in-row Hillis-Steele over ``block`` lanes, a
    carry scan over the row ends, then one fused combine."""
    k = b.shape[0]
    r = -(-k // block)
    dev = b.device
    bp = F.pad(b, (0, r * block - k)).reshape(r, block)
    s_in = _iir_row_scan(bp, c)
    cl = float(c) ** block
    ends = _iir_row_scan(s_in[:, -1], cl)
    decay = device_const(_powers, float(np.float32(cl)), 0, r, device=dev)
    car = (torch.cat([torch.zeros(1, dtype=b.dtype, device=dev), ends[:-1]])
           + decay * avg)
    cvec = device_const(_powers, float(c), 1, block + 1, device=dev)
    y = (s_in + car[:, None] * cvec[None, :]).reshape(-1)[:k]
    return y[-1], y


# test hook: force the matmul scan form on the CPU as well
_MXU_FORCE = False


def deemph_mxu_path(device=None) -> bool:
    """True when :func:`deemph_filter` on ``device`` (default: the
    resolved device, ``device.resolve_device``) takes the triangular
    matmul form (CUDA, or forced) — the scan engine's batched tail gates
    on it to stay bit-identical to per-block calls."""
    return _MXU_FORCE or resolve_device(device).type == "cuda"


def _iir_scan_batch_mxu(avg, b, c: float, lanes: int = 128):
    """Batched (C, M) minor-axis scan via the triangular float32 matmul
    (M %% lanes == 0): the stack reshapes row-major to (C*M/lanes, lanes)
    with every row inside one channel, and the row-carry scan runs per
    channel over the (C, M/lanes) row-end grid."""
    cdim, m = b.shape
    rows = m // lanes
    dev = b.device
    s_in = (b.reshape(cdim * rows, lanes)
            @ device_const(_scan_matrix, lanes, float(c), device=dev))
    cl = float(c) ** lanes
    ends_scan = _iir_row_scan(s_in[:, -1].reshape(cdim, rows), cl)  # (C, R)
    car = (torch.cat([torch.zeros((cdim, 1), dtype=b.dtype, device=dev),
                      ends_scan[:, :-1]], dim=1)
           + device_const(_powers, cl, 0, rows, device=dev)[None, :]
           * avg[:, None])                                        # (C, R)
    cvec = device_const(_powers, float(c), 1, lanes + 1, device=dev)
    y = (s_in.reshape(cdim, rows, lanes)
         + car[:, :, None] * cvec[None, None, :]).reshape(cdim, m)
    return y[:, -1], y


def deemph_filter(avg, x, deemph_a: int, axis: int = 0):
    """(carry, block) -> (carry, block) one-pole IIR, parallel-scan form.

    ``axis`` selects the time axis: 0 for a flat (N,) stream, -1/1 for a
    batched (C, N) channel stack (``avg`` then has shape (C,))."""
    if x.dim() > 1 and axis not in (-1, 1):
        # the scans run along the minor axis; a 2-D input with axis=0
        # would silently compute the wrong recurrence
        raise ValueError(
            f"deemph_filter on a {x.dim()}-D input scans the minor axis; "
            f"got axis={axis} (transpose the input or pass axis=-1)")
    inv_a = float(1.0 / deemph_a)
    c = 1.0 - inv_a
    b = x * _f32(inv_a)
    if x.dim() == 1:
        if deemph_mxu_path(x.device):
            return _iir_scan_flat_mxu(avg, b, c)
        return _iir_scan_flat(avg, b, c)
    # batched (C, M): the matmul form on the card, the row scan on the CPU
    m = x.shape[-1]
    if deemph_mxu_path(x.device) and m % 128 == 0:
        return _iir_scan_batch_mxu(avg, b, c)
    s_in = _iir_row_scan(b, c)
    y = s_in + avg[..., None] * device_const(_powers, float(c), 1, m + 1,
                                             device=x.device)
    return y[..., -1], y


def deemph_blocks(avg, x, deemph_a: int):
    """``M`` sequential per-block :func:`deemph_filter` calls at once:
    ``x`` (M, K) -> ``(avg_end, y (M, K))``, the same values as the loop on
    the matmul path (gate on :func:`deemph_mxu_path`).

    The in-row triangular products of every block run as one product and
    the per-block row-end scans run batched; only the cross-block average
    chain — M scalar steps replaying the exact float32 operations the
    per-block call uses for its last element — is sequential.
    """
    inv_a = float(1.0 / deemph_a)
    c = 1.0 - inv_a
    b = x * _f32(inv_a)
    mblk, k = b.shape
    lanes = 128
    r = -(-k // lanes)
    dev = b.device
    bp = F.pad(b, (0, r * lanes - k)).reshape(mblk * r, lanes)
    s_in = bp @ device_const(_scan_matrix, lanes, float(c), device=dev)
    cl = float(c) ** lanes
    ends = s_in[:, -1].reshape(mblk, r)
    ends_scan = _iir_row_scan(ends, cl)                        # (M, R)
    decay = device_const(_powers, cl, 0, r, device=dev)
    cvec = device_const(_powers, float(c), 1, lanes + 1, device=dev)
    last_row = (k - 1) // lanes
    last_lane = (k - 1) % lanes
    s3 = s_in.reshape(mblk, r, lanes)
    s_last = s3[:, last_row, last_lane]                        # (M,)
    base = torch.cat([torch.zeros((mblk, 1), dtype=b.dtype, device=dev),
                      ends_scan[:, :-1]], dim=1)               # (M, R)
    base_last = base[:, last_row]
    dlast = _f32(cl ** last_row)
    avgs = [avg]
    for i in range(mblk):
        car_last = base_last[i] + dlast * avgs[i]
        avgs.append(s_last[i] + car_last * cvec[last_lane])
    avg_vec = torch.stack(avgs[:-1])                           # (M,) starts
    car = base + decay[None, :] * avg_vec[:, None]
    y = (s3 + car[:, :, None] * cvec[None, None, :]).reshape(mblk, -1)[:, :k]
    return avgs[-1], y


def dc_block_audio(dc_avg, x, block_const: int = 9):
    """(carry, block) -> (carry, block); rtl_fm.c:684-697."""
    avg = torch.mean(x)
    avg = div_const(avg + dc_avg * float(block_const),
                    float(block_const + 1))
    return avg, x - avg


def dc_block_raw(dc_iq, x, block_const: int = 9):
    """Raw I/Q DC block before demodulation (``-E rdc``, rtl_fm.c:699-721):
    ``dc_iq`` (2,) carried averages, ``x`` (N, 2)."""
    avg = torch.mean(x, dim=0)
    avg = div_const(avg + dc_iq * float(block_const), float(block_const + 1))
    return avg, x - avg[None, :]


def mad_level(x):
    """Mean absolute deviation (``mad``, ``rtl_fm.c:722-737``) of ``x``,
    any shape, pooled.  The reference ships it but never calls it; the
    C's truncating integer mean is a float mean here, as in
    :mod:`rx_tools_tpu.ops.filters`."""
    v = x.reshape(-1)
    n = float(v.shape[0])
    avg = div_const(torch.sum(v), n)
    return div_const(torch.sum(torch.abs(v - avg)), n)


def rms_level(x):
    """RMS over all components of an interleaved ``(N, 2)`` block pooled,
    with DC correction (``rms(lowpassed, len, 1)``, rtl_fm.c:739-757)."""
    v = x.reshape(-1)
    return _rms_from_sums(torch.sum(v), torch.sum(v * v), float(v.shape[0]))


def rms_level_planar(zi, zq):
    """RMS over all I and Q components pooled, with DC correction
    (``rms``, rtl_fm.c:739-757), from planar streams."""
    n = float(2 * zi.shape[0])
    t = torch.sum(zi) + torch.sum(zq)
    p = torch.sum(zi * zi) + torch.sum(zq * zq)
    return _rms_from_sums(t, p, n)


def _rms_from_sums(t, p, n: float):
    """The reference's DC-corrected RMS from the sum ``t`` and the sum of
    squares ``p`` of ``n`` components."""
    dc = div_const(t, n)
    err = t * 2.0 * dc - dc * dc * n
    return torch.sqrt(div_const(torch.clamp(p - err, min=0.0), n))
