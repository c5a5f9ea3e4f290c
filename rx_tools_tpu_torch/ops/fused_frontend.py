"""One-kernel capture+demod front: rescale -> fs/4 -> decimate -> fast-atan
FM discriminator -> squelch-level partials (K2).

Counterpart of :mod:`rx_tools_tpu.ops.fused_frontend`.  The CUDA kernel
``kernels/csrc/fused_capture_fm.cu`` keeps the decimated stream on chip from
the capture head through the discriminator and writes only the
discriminator output, per-tile level partials and, in the same launch
(the last CTA to finish sums them), each block's RMS level; block seams
(sample 0 of every block, std atan2 regardless of ``-A``, ``fm_demod``
rtl_fm.c:588-590) are computed in the kernel.

- :func:`fused_capture_fm` launches the kernel on a CUDA tensor and counts
  the launch;
- :func:`fused_capture_fm_demod` is the front the engines call: the kernel
  on CUDA, :func:`fused_capture_fm_plain` on the CPU;
- :func:`fused_eligible` gates it: FM with the fast atan, squelch off,
  boxcar decimation, and the opt-in (``RX_FUSED=1`` or ``fused=True``).
  The TPU kernel's tile gates (``K % 32``, tile rows a multiple of 32) do
  not apply to the CUDA kernel.
"""

from __future__ import annotations

import os

import torch

from rx_tools_tpu_torch import kernels
from rx_tools_tpu_torch.kernels import plan
from rx_tools_tpu_torch.ops.discriminators import polar_discriminant
from rx_tools_tpu_torch.ops.filters import _rms_from_sums
from rx_tools_tpu_torch.ops.frontend_mxu import (_pallas_options,
                                                 capture_head_plain)
from rx_tools_tpu_torch.ops.pallas_frontend import _SCALE

_PI4 = float(1 << 12)
_PI34 = float(3 * (1 << 12))
#: the kernel's ring holds two stages of at least 128 rows of D int16
#: pairs in shared memory (at most 227 KB; ``kernels/plan.py``)
_MAX_D = 200


def fused_eligible(cfg, k_per_block: int, fused: bool | None = None
                   ) -> bool:
    """True when the one-kernel front covers ``cfg`` at ``k_per_block``
    output samples a block and it is asked for: ``fused`` if given, else
    ``RX_FUSED=1``; FM with the fast-atan discriminator, squelch off, no
    raw DC block, boxcar decimation, and a block of at least one sample.

    The reference's signature.  Its gate also requires the TPU backend
    and a block that its Pallas tiles divide (``pick_tile_rows``); the
    CUDA kernel takes any block, and the switch holds on any device: a
    CPU tensor runs the kernel's plain version
    (:func:`fused_capture_fm_plain`)."""
    if fused is None:
        fused = os.environ.get("RX_FUSED", "") == "1"
    return (bool(fused) and int(k_per_block) > 0 and cfg.mode == "fm"
            and cfg.custom_atan == 1 and cfg.squelch_level == 0
            and not cfg.dc_block_raw and not cfg.downsample_passes
            and cfg.fir_quality <= 9)


def _check_geometry(blocks_flat: torch.Tensor, downsample: int,
                    k_per_block: int) -> int:
    d = int(downsample)
    if blocks_flat.dim() != 1 or k_per_block <= 0:
        raise ValueError("fused front: expected a flat int16 chunk")
    per_block = 2 * d * int(k_per_block)
    if blocks_flat.numel() % per_block:
        raise ValueError(f"fused front: {blocks_flat.numel()} int16 is not "
                         f"a whole number of {per_block}-element blocks")
    return blocks_flat.numel() // per_block


_tickets: dict[tuple[str, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """The kernel's ticket counter on ``dev`` for ``stream``: one zeroed
    uint32, allocated once; every launch leaves it at zero.  One per
    stream, so launches on two streams never share a count."""
    key = (str(dev), stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def fused_capture_fm(prev_iq: torch.Tensor, blocks_flat: torch.Tensor,
                     downsample: int, k_per_block: int, rotate: bool = True,
                     *, grid: int | None = None):
    """Launch the K2 kernel on a CUDA chunk of M blocks: one launch.

    Returns ``(d (K,), levels (M,), last (2,))``: the discriminator stream
    with std-atan2 seams, each block's RMS level (the block's tile
    partials summed in tile order by the last CTA to finish) and the
    chunk's last decimated sample.  ``grid`` forces the number of CTAs
    (default: one resident wave; the results do not depend on it).

    This contract differs from the reference's ``fused_capture_fm(block,
    downsample, rotate, tile_rows, interpret)`` by design.  The TPU runs
    its grid in order and carries each tile's last sample to the next in
    SMEM (``rx_tools_tpu/ops/fused_frontend.py:104-118``), so it takes one
    block and leaves the seams and per-tile partials to its caller.  The
    CUDA kernel's CTAs run in any order: each tile reads a halo of the
    samples before it instead, so the kernel takes the previous sample
    (``prev_iq``) and a chunk of M blocks, and finishes the seams and the
    per-block levels itself."""
    kernels.require_cuda_int16(blocks_flat, "fused_capture_fm")
    d = int(downsample)
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"fused_capture_fm: downsample {d} outside "
                         f"1..{_MAX_D}")
    m = _check_geometry(blocks_flat, d, k_per_block)
    dev = blocks_flat.device
    if (prev_iq.device != dev or prev_iq.dtype != torch.float32
            or prev_iq.shape != (2,)):
        raise ValueError("fused_capture_fm: prev_iq must be float32 (2,) "
                         "on the chunk's device")
    prev_iq = prev_iq.contiguous()
    p = plan.plan("fused_capture_fm", d)
    tiles = m * plan.fused_tiles_per_block(p, k_per_block)
    if grid is None:
        grid = kernels.grid(p, tiles, dev)
    d_out = torch.empty(m * k_per_block, dtype=torch.float32, device=dev)
    partials = torch.empty((tiles, 2), dtype=torch.float32, device=dev)
    levels = torch.empty(m, dtype=torch.float32, device=dev)
    last = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = kernels.stream_handle(dev)
        err = kernels.lib("fused_capture_fm").rx_fused_capture_fm(
            blocks_flat.data_ptr(), prev_iq.data_ptr(), d_out.data_ptr(),
            partials.data_ptr(), levels.data_ptr(), last.data_ptr(),
            _ticket(dev, stream).data_ptr(), m, int(k_per_block), d,
            int(rotate), float(_SCALE), p.rows, p.threads, p.stages,
            p.stage_bytes, int(grid), stream)
    kernels.check(err, "fused_capture_fm")
    fused_capture_fm.launches += 1
    return d_out, levels, last


fused_capture_fm.launches = 0


def fused_capture_fm_plain(prev_iq: torch.Tensor, blocks_flat: torch.Tensor,
                           downsample: int, k_per_block: int,
                           rotate: bool = True):
    """The kernel's plain PyTorch version, on any device: the same
    elementwise arithmetic (one divide per sample, 0/0 -> 0 by a select),
    std-atan2 seams, per-block levels.  Returns
    ``(new_prev (2,), d (K,), levels (M,))``."""
    m = _check_geometry(blocks_flat, downsample, k_per_block)
    zi, zq = capture_head_plain(blocks_flat, downsample, rotate)
    pi = torch.cat([prev_iq[0:1], zi[:-1]])
    pq = torch.cat([prev_iq[1:2], zq[:-1]])
    cr = zi * pi + zq * pq
    cj = zq * pi - zi * pq
    yabs = torch.abs(cj)
    pos = cr >= 0
    num = torch.where(pos, cr - yabs, cr + yabs)
    den = torch.where(pos, cr + yabs, yabs - cr)
    base = torch.where(pos, torch.full_like(cr, _PI4),
                       torch.full_like(cr, _PI34))
    ang = base - _PI4 * (num / den)
    ang = torch.where((cr == 0) & (cj == 0), torch.zeros_like(ang), ang)
    d = torch.where(cj < 0, -ang, ang)
    idx = torch.arange(0, d.shape[0], int(k_per_block), device=d.device)
    d[idx] = polar_discriminant(cr[idx], cj[idx])
    t = (zi + zq).reshape(m, k_per_block).sum(dim=1)
    p = (zi * zi + zq * zq).reshape(m, k_per_block).sum(dim=1)
    levels = _rms_from_sums(t, p, float(2 * k_per_block))
    return torch.stack([zi[-1], zq[-1]]), d, levels


def fused_capture_fm_demod(prev_iq: torch.Tensor, blocks_flat: torch.Tensor,
                           downsample: int, k_per_block: int,
                           rotate: bool = True, interpret: bool = False):
    """The fused front of the chain engines: ``blocks_flat`` (M*2N,) int16,
    M blocks of ``k_per_block`` output samples.  Returns
    ``(new_prev_iq (2,), d (K,), levels (M,))`` with the semantics of the
    capture head + ``fm_discriminate_planar(..., seam_stride=k_per_block)``
    + the rms level formula.  K2 on CUDA, the plain version on the CPU;
    ``interpret=True`` (the reference's Pallas interpreter) raises
    ``ValueError``."""
    _pallas_options("fused_capture_fm_demod", interpret)
    if blocks_flat.device.type == "cpu":
        return fused_capture_fm_plain(prev_iq, blocks_flat, downsample,
                                      k_per_block, rotate)
    d, levels, last = fused_capture_fm(prev_iq, blocks_flat, downsample,
                                       k_per_block, rotate)
    return last, d, levels
