"""Scan-free chunk processing: the whole FM chain as chunk-wide passes.

Counterpart of :mod:`rx_tools_tpu.models.fmchunk` (``RX_ENGINE=flat``).
An (M, 2N) chunk runs as one set of chunk-wide ops: the capture head (or
the fused front) over all M blocks at once, the discriminator with the
std-atan seam every block, one de-emphasis scan and one resampler call
over the whole chunk.  The carried state is the same :class:`FmState`
as ``fm_chain_step``'s, so the engines interoperate; the audio agrees with
the per-block engine at float tolerance (the reference's tests hold the
two at rtol 1e-4 / atol 0.02), not bit for bit.
"""

from __future__ import annotations

import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.ops.filters import _rms_from_sums
from rx_tools_tpu_torch.ops.fused_frontend import (fused_capture_fm_demod,
                                                   fused_eligible)


def supports(cfg: fmchain.FmConfig) -> bool:
    """Configs the flat formulation covers (the common/hot ones)."""
    return (cfg.downsample_passes == 0 and cfg.fir_quality <= 9
            and cfg.resample_quality == 0
            and cfg.mode in ("fm", "am", "usb", "lsb", "raw"))


def _ema_scan(means: torch.Tensor, prev: torch.Tensor, block_const: int):
    """avg_k = (means_k + c*avg_{k-1}) / (c+1) over the leading axis, as
    the affine composition the reference scans: A_k = a**(k+1),
    B_k = a*B_{k-1} + b_k, avg_k = B_k + A_k*prev with a = c/(c+1)."""
    c = torch.full((), float(block_const), dtype=torch.float32,
                   device=means.device)
    a = c / (c + 1.0)
    b = means / (c + 1.0)
    acc_a, acc_b = a, b[0]
    out = [acc_b + acc_a * prev]
    for k in range(1, means.shape[0]):
        acc_a = acc_a * a
        acc_b = acc_b * a + b[k]
        out.append(acc_b + acc_a * prev)
    return torch.stack(out)


def fm_chunk_step(cfg: fmchain.FmConfig, state: fmchain.FmState, blocks,
                  fused: bool | None = None):
    """(M, 2N) int16 -> (state, audio (cap,), n_valid, levels (M,)).

    One chunk-wide program; carried state identical to
    ``fm_chain_step``'s so engines interoperate.  ``fused`` selects the
    one-kernel front (default: ``RX_FUSED``)."""
    if not supports(cfg):
        raise ValueError("config not supported by the flat engine")
    fmchain.check_supported(cfg)
    dev = state.prev_iq.device
    blocks = fmchain.as_block(blocks, dev)
    m, twon = blocks.shape
    n = twon // 2
    d = cfg.downsample
    kpb = n // d
    rotate = not cfg.offset_tuning
    if fused_eligible(cfg, kpb, fused=fused):
        prev_iq, audio, levels = fused_capture_fm_demod(
            state.prev_iq, blocks.reshape(-1), d, kpb, rotate=rotate)
        return _fm_tail(cfg, state, audio, levels, prev_iq,
                        state.squelch_hits, m)
    if cfg.dc_block_raw:
        # raw DC block: the per-block EMA of the block means as one affine
        # scan, then fs/4 derotate and the aligned boxcar in torch ops
        x = fmchain.rescale_cs16(blocks.reshape(-1)).reshape(m, n, 2)
        avgs = _ema_scan(x.mean(dim=1), state.dc_iq, 9)        # (M, 2)
        x = (x - avgs[:, None, :]).reshape(m * n, 2)
        if rotate:
            x = ops.rotate_fs4(x)
        z = x.reshape(m * kpb, d, 2).sum(dim=1)
        zi, zq = z[:, 0].contiguous(), z[:, 1].contiguous()
        state = state._replace(dc_iq=avgs[-1])
    else:
        # capture head over the whole chunk at once, planar output; the
        # fs/4 phase is continuous across blocks because n % 4 == 0
        zi, zq = ops.capture_frontend_planar(blocks.reshape(-1), d, rotate)

    # --- squelch levels per block ---------------------------------------
    zib = zi.reshape(m, kpb)
    zqb = zq.reshape(m, kpb)
    t = zib.sum(dim=1) + zqb.sum(dim=1)
    p = (zib * zib).sum(dim=1) + (zqb * zqb).sum(dim=1)
    levels = _rms_from_sums(t, p, float(2 * kpb))
    squelch_hits = state.squelch_hits
    if cfg.squelch_level > 0:
        squelched = levels < cfg.squelch_level
        zi = torch.where(squelched[:, None], torch.zeros_like(zib),
                         zib).reshape(-1)
        zq = torch.where(squelched[:, None], torch.zeros_like(zqb),
                         zqb).reshape(-1)
        # consecutive run length of squelched blocks ending at the last one
        run = torch.cumprod(squelched.flip(0).to(torch.int32), dim=0).flip(0)
        tail_hits = run.sum(dtype=torch.int32)
        squelch_hits = torch.where(tail_hits == m, squelch_hits + m,
                                   tail_hits)

    prev_iq, audio = fmchain._demod(cfg, state.prev_iq, zi, zq,
                                    seam_stride=kpb)
    if cfg.mode == "raw":
        return (state._replace(squelch_hits=squelch_hits), audio,
                fmchain._count(audio), levels)
    return _fm_tail(cfg, state, audio, levels, prev_iq, squelch_hits, m)


def _fm_tail(cfg, state, audio, levels, prev_iq, squelch_hits, m):
    """Shared audio post-processing: post-downsample, deemph, audio DC
    block, rational resample, state assembly (both front paths)."""
    if cfg.post_downsample > 1:
        audio = ops.low_pass_simple(audio, cfg.post_downsample)
    deemph_avg = state.deemph_avg
    if cfg.deemph_a:
        deemph_avg, audio = ops.deemph_filter(deemph_avg, audio, cfg.deemph_a)
    dc_avg = state.dc_avg
    if cfg.dc_block_audio:
        ab = audio.reshape(m, -1)
        means = ab.mean(dim=1)
        avgs = _ema_scan(means, state.dc_avg, 9)
        audio = (ab - avgs[:, None]).reshape(-1)
        dc_avg = avgs[-1]
    resamp = state.resamp
    if cfg.rate_out2 > 0:
        resamp, audio, n_valid = ops.resample_rational(
            resamp, audio, cfg.rate_out, cfg.rate_out2)
    else:
        n_valid = fmchain._count(audio)
    new_state = state._replace(prev_iq=prev_iq, deemph_avg=deemph_avg,
                               dc_avg=dc_avg, resamp=resamp,
                               squelch_hits=squelch_hits)
    return new_state, audio, n_valid, levels
