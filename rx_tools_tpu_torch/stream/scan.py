"""Chunk processing with per-block semantics: the default rx_fm engine.

Counterpart of :mod:`rx_tools_tpu.stream.scan`.  A chunk of M blocks
moves to the device once and runs as

    blocks (M, 2N) -> audio (M, cap), n_valid (M,), levels (M,)

with the carried state threading through exactly as it threads between
the reference's buffer handoffs (``src/rtl_fm.c:866-958``).

The capture-rate front half (rescale + fs/4 rotate + decimate,
``rtlsdr_callback`` rtl_fm.c:828-863, plus the discriminator) carries no
cross-block state on the boxcar path, so it runs once over the whole
chunk (one capture-head launch per chunk); the audio tail keeps per-block
semantics with the carried state, so the output equals stepping
``fm_chain_step`` block by block.  On the CPU that equality is bit for bit
(the tests pin it).  On CUDA the batched tail's matrix products may run
other cuBLAS algorithms than the per-block ones, so equality is held at
float rounding there.  Stateful-front configs (squelch gating, the opt-in
fused kernel) and the stateful heads (fifth-order cascade, polyphase
FIR, raw DC block) take the per-block loop.
"""

from __future__ import annotations

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.ops import filters
from rx_tools_tpu_torch.ops.fused_frontend import fused_eligible
from rx_tools_tpu_torch.ops.resample import (resample_rows_blocks,
                                             rows_path_eligible)


def stack_blocks(iq: np.ndarray, block_size: int) -> np.ndarray:
    """Chop interleaved CS16 into (M, 2*block_size); truncate the tail."""
    n = iq.shape[0] // (2 * block_size)
    return iq[: n * 2 * block_size].reshape(n, 2 * block_size)


def _batched_front_ok(cfg: fmchain.FmConfig, k_per_block: int,
                      fused: bool | None) -> bool:
    """The chunk-wide front needs a stateless capture path: the boxcar head
    (no fifth-order, polyphase-FIR or raw-DC history to carry from block to
    block), squelch off (per-block zeroing feeds the discriminator) and not
    the opt-in fused kernel (which fuses capture+disc per block by
    design)."""
    return (fmchain.boxcar_head(cfg) and cfg.squelch_level == 0
            and not fused_eligible(cfg, k_per_block, fused=fused))


def scan_fm_blocks(cfg: fmchain.FmConfig, state: fmchain.FmState, blocks,
                   fused: bool | None = None):
    """Run the FM chain over ``blocks`` (M, 2N) int16.  Returns
    ``(state, audio (M, cap), n_valid (M,), levels (M,))`` — the values of
    stepping ``fm_chain_step`` per block."""
    fmchain.check_supported(cfg)
    blocks = fmchain.as_block(blocks, state.prev_iq.device)
    kpb = blocks.shape[-1] // 2 // cfg.downsample
    if _batched_front_ok(cfg, kpb, fused):
        return _scan_batched_front(cfg, state, blocks)
    audio, n_valid, levels = [], [], []
    for i in range(blocks.shape[0]):
        state, a, nv, lv = fmchain.fm_chain_step(cfg, state, blocks[i],
                                                 fused=fused)
        audio.append(a)
        n_valid.append(nv)
        levels.append(lv)
    return (state, torch.stack(audio), torch.stack(n_valid),
            torch.stack(levels))


def _scan_batched_front(cfg, state, blocks):
    """Chunk-wide capture front + discriminator, per-block audio tail.

    The front is elementwise/windowed with no cross-block state (the fs/4
    phase is continuous because N % 4 == 0, and every decimation window
    lies inside one block), so one chunk-wide call computes what M
    per-block calls would, value for value; the std-atan2 seam stays at
    every block boundary via ``seam_stride``.  The tail replays
    ``_fm_post`` per block with the carried state — or, when every
    per-block resampler call would take the rows path, runs the per-block
    de-emphasis and resampler sequences batched with the loop's values.
    """
    m, twon = blocks.shape
    kpb = twon // 2 // cfg.downsample
    dev = blocks.device

    zi, zq = ops.capture_frontend_planar(blocks.reshape(-1), cfg.downsample,
                                         not cfg.offset_tuning)
    prev_iq, d = fmchain._demod(cfg, state.prev_iq, zi, zq, seam_stride=kpb)

    k2 = kpb // max(cfg.post_downsample, 1)
    batched_rs = (cfg.mode != "raw" and cfg.rate_out2 > 0
                  and cfg.resample_quality == 0
                  and not cfg.dc_block_audio
                  and rows_path_eligible(k2, cfg.rate_out, cfg.rate_out2,
                                         dev))
    batched_deemph = bool(batched_rs and cfg.deemph_a
                          and filters.deemph_mxu_path(dev))
    lv = _rms_level_rows(zi.reshape(m, kpb), zq.reshape(m, kpb))

    audio, n_valid = [], []
    st = state
    deemph_avg = state.deemph_avg
    for i in range(m):
        if cfg.mode == "raw":
            # raw leaves the carried state untouched on this path
            # (no discriminator seam, no IIR tail — rtl_fm.c:658-665)
            a = d[2 * i * kpb: 2 * (i + 1) * kpb]
            audio.append(a)
            n_valid.append(fmchain._count(a))
            continue
        a = d[i * kpb: (i + 1) * kpb]
        if batched_rs:
            # _fm_post's per-block stages up to the resampler; deemph joins
            # the batched pass below when on the matmul path
            if cfg.post_downsample > 1:
                a = ops.low_pass_simple(a, cfg.post_downsample)
            if cfg.deemph_a and not batched_deemph:
                deemph_avg, a = ops.deemph_filter(deemph_avg, a, cfg.deemph_a)
            audio.append(a)
            continue
        st, a_out, nv, _ = fmchain._fm_post(cfg, st, a, lv[i], prev_iq,
                                            st.squelch_hits)
        audio.append(a_out)
        n_valid.append(nv)
    if batched_rs:
        a2 = torch.stack(audio)                             # (M, K2)
        if batched_deemph:
            deemph_avg, a2 = filters.deemph_blocks(deemph_avg, a2,
                                                   cfg.deemph_a)
        resamp, y, nv = resample_rows_blocks(st.resamp, a2, cfg.rate_out,
                                             cfg.rate_out2)
        st = st._replace(prev_iq=prev_iq, deemph_avg=deemph_avg,
                         resamp=resamp)
        return st, y, nv, lv
    return st, torch.stack(audio), torch.stack(n_valid), lv


def _rms_level_rows(zib, zqb):
    """Per-block squelch RMS over an (M, K) row stack — the per-row
    operations of ``ops.rms_level_planar`` (``rms``, rtl_fm.c:739-757)."""
    t = torch.sum(zib, dim=1) + torch.sum(zqb, dim=1)
    p = torch.sum(zib * zib, dim=1) + torch.sum(zqb * zqb, dim=1)
    return filters._rms_from_sums(t, p, float(2 * zib.shape[1]))


def gather_valid(audio: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Host-side: concatenate the valid prefixes of each scanned block."""
    return np.concatenate([audio[i, : int(n_valid[i])]
                           for i in range(audio.shape[0])])
