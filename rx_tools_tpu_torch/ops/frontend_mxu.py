"""The capture head as a hand-written CUDA kernel, and its plain versions.

Counterpart of :mod:`rx_tools_tpu.ops.frontend_mxu`.  The head — CS16
rescale (``rtl_fm.c:845-848``), fs/4 derotation (``rtl_fm.c:309-327``) and
boxcar decimate by D (``rtl_fm.c:351-371``) — maps each output sample k to

    z[k] = SCALE * sum_j x[Dk+j] * i**(Dk+j)

over the interleaved int16 stream.  On the TPU it ran as a matrix product
against the {+1, 0, -1} block-banded matrix (:func:`_fs4_decim_matrix`).
Here the kernel ``kernels/csrc/capture_head.cu`` sums the same signed
int16 terms in int32 per output sample and scales once, so the result is
integer-exact and equals :func:`capture_head_plain` bit for bit.  It runs
one resident wave of persistent CTAs over tiles whose size depends on D
alone (``kernels/plan.py``), each fed by a ring of bulk-copied stages.

Entry points (each a wrapper with a ``launches`` count of its CUDA
launches; on a CPU tensor each runs the plain version):

- :func:`capture_frontend_mm_pallas` (K1) — planar ``(zi, zq)``; the
  production head of every engine;
- :func:`capture_frontend_mm_pallas2` (K4) — the two-output twin, the
  same planar result;
- ``ops.pallas_frontend.capture_frontend_pallas`` (K3) — interleaved
  ``(K, 2)``, on the same kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rx_tools_tpu_torch import kernels
from rx_tools_tpu_torch.kernels import plan
from rx_tools_tpu_torch.ops.numeric import device_const
from rx_tools_tpu_torch.ops.pallas_frontend import _SCALE, _fs4_decim_masks

#: the kernel's ring holds two stages of at least 16 rows of D int16
#: pairs in shared memory (at most 227 KB; ``kernels/plan.py``)
_MAX_D = 1800


def _group_phase_select(zi, zq, d: int):
    """Apply the per-output-sample group phase ``i**(D*k)`` elementwise."""
    k = torch.arange(zi.shape[0], dtype=torch.int64, device=zi.device)
    p = (k * (d & 3)) & 3
    return (torch.where(p == 0, zi, torch.where(p == 1, -zq,
                        torch.where(p == 2, -zi, zq))),
            torch.where(p == 0, zq, torch.where(p == 1, zi,
                        torch.where(p == 2, -zq, -zi))))


@functools.lru_cache(maxsize=32)
def _fs4_decim_matrix(d: int, p: int, rotate: bool) -> np.ndarray:
    """(P*2D, 2P) block-banded mask matrix, group phase folded per column.

    Column j in [0, P) is Re(z[r*P+j]), column P+j is Im; rows
    [j*2D, (j+1)*2D) carry the fs/4+decimate masks for phase j rotated by
    ``i**(D*j mod 4)`` (valid because P % 4 == 0 tiles the phase pattern).
    """
    if rotate and d % 4 and p % 4:
        raise ValueError(f"phase block {p} does not tile the fs/4 phase")
    a, b = _fs4_decim_masks(d, rotate)
    m = np.zeros((p * 2 * d, 2 * p), np.float32)
    for j in range(p):
        ph = (d * j) & 3 if rotate else 0
        if ph == 0:
            re, im = a, b
        elif ph == 1:
            re, im = -b, a
        elif ph == 2:
            re, im = -a, -b
        else:
            re, im = b, -a
        rows = slice(j * 2 * d, (j + 1) * 2 * d)
        m[rows, j] = re
        m[rows, p + j] = im
    return m


def _pick_p(k: int, d: int, rotate: bool) -> int:
    """Largest supported phase-block size dividing the output length."""
    need4 = rotate and (d & 3) != 0
    for cand in (32, 16, 8, 4):
        if k % cand == 0:
            return cand
    if not need4 and k % 2 == 0:
        return 2
    return 1


def _int_masks(d: int, rotate: bool) -> np.ndarray:
    """(2, 2D) int32: the Re and Im masks of :func:`_fs4_decim_masks`."""
    return np.stack(_fs4_decim_masks(d, rotate)).astype(np.int32)


def _rows(block_i16: torch.Tensor, d: int) -> int:
    if block_i16.dim() != 1 or block_i16.numel() % (2 * d):
        raise ValueError(f"capture head: {tuple(block_i16.shape)} int16 is "
                         f"not a whole number of 2*D={2 * d} groups")
    return block_i16.numel() // (2 * d)


def capture_head_plain(block_i16: torch.Tensor, downsample: int,
                       rotate: bool = True, interleaved: bool = False):
    """The kernel's plain PyTorch version, on any device.

    ``(2N,) int16 -> (zi (K,), zq (K,))`` float32, or ``(K, 2)`` when
    ``interleaved``: int32 masked sums of the raw stream, the group phase
    by select, one float32 multiply by ``_SCALE``.  Integer-exact.
    """
    d = int(downsample)
    k = _rows(block_i16, d)
    g = block_i16.reshape(k, 2 * d).to(torch.int32)
    masks = device_const(_int_masks, d, bool(rotate),
                         device=block_i16.device)
    zi = (g * masks[0]).sum(dim=1)
    zq = (g * masks[1]).sum(dim=1)
    if rotate and d % 4:
        zi, zq = _group_phase_select(zi, zq, d)
    scale = float(_SCALE)
    zi = zi.to(torch.float32) * scale
    zq = zq.to(torch.float32) * scale
    if interleaved:
        return torch.stack([zi, zq], dim=-1)
    return zi, zq


def capture_frontend_mm_i16(block_i16: torch.Tensor, downsample: int,
                            rotate: bool = True, p: int | None = None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, the plain integer
    head in the reference's matrix form: ``(K/P, P*2D) @ (P*2D, 2P)``
    against :func:`_fs4_decim_matrix`, accumulated exactly (float64 holds
    every partial sum of int16 terms), then one float32 scale.  Equals
    :func:`capture_head_plain` bit for bit; ``p == 1`` (no usable phase
    block) computes through it directly."""
    d = int(downsample)
    k = _rows(block_i16, d)
    if p is None:
        p = _pick_p(k, d, rotate)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    g = block_i16.reshape(k // p, p * 2 * d).to(torch.float64)
    m = device_const(_fs4_decim_matrix, d, p, bool(rotate),
                     device=block_i16.device).to(torch.float64)
    out = (g @ m).to(torch.float32) * float(_SCALE)
    return out[:, :p].reshape(-1), out[:, p:].reshape(-1)


def _launch_head(block_i16: torch.Tensor, downsample: int, rotate: bool,
                 interleaved: bool, what: str, grid: int | None = None):
    """Launch ``capture_head.cu`` on a CUDA tensor; returns the outputs.
    ``grid`` forces the number of CTAs (default: one resident wave)."""
    kernels.require_cuda_int16(block_i16, what)
    d = int(downsample)
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"{what}: downsample {d} outside 1..{_MAX_D}")
    k = _rows(block_i16, d)
    dev = block_i16.device
    if interleaved:
        out_a = torch.empty((k, 2), dtype=torch.float32, device=dev)
        out_b = None
    else:
        out_a = torch.empty(k, dtype=torch.float32, device=dev)
        out_b = torch.empty(k, dtype=torch.float32, device=dev)
    p = plan.plan("capture_head", d)
    if grid is None:
        grid = kernels.grid(p, plan.head_tiles(p, k), dev)
    with torch.cuda.device(dev):
        err = kernels.lib("capture_head").rx_capture_head(
            block_i16.data_ptr(), out_a.data_ptr(),
            None if out_b is None else out_b.data_ptr(), k, d, int(rotate),
            int(interleaved), float(_SCALE), p.rows, p.stages, p.stage_bytes,
            int(grid), kernels.stream_handle(dev))
    kernels.check(err, what)
    return out_a if interleaved else (out_a, out_b)


def capture_frontend_mm_pallas(block_i16: torch.Tensor, downsample: int,
                               rotate: bool = True):
    """K1: ``(2N,) int16 -> ((K,), (K,)) float32`` planar capture head.

    Launches ``capture_head.cu`` for a CUDA tensor (any K; the TPU's
    ``K % P`` gate does not apply) and counts the launch; a CPU tensor
    runs :func:`capture_head_plain`."""
    if block_i16.device.type == "cpu":
        return capture_head_plain(block_i16, downsample, rotate)
    out = _launch_head(block_i16, downsample, rotate, False,
                       "capture_frontend_mm_pallas")
    capture_frontend_mm_pallas.launches += 1
    return out


capture_frontend_mm_pallas.launches = 0


def capture_frontend_mm_pallas2(block_i16: torch.Tensor, downsample: int,
                                rotate: bool = True):
    """K4: the two-output twin of K1 — separate Re and Im planes, which
    are K1's planar layout; same kernel, its own launch count."""
    if block_i16.device.type == "cpu":
        return capture_head_plain(block_i16, downsample, rotate)
    out = _launch_head(block_i16, downsample, rotate, False,
                       "capture_frontend_mm_pallas2")
    capture_frontend_mm_pallas2.launches += 1
    return out


capture_frontend_mm_pallas2.launches = 0
