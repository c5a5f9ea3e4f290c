"""The demodulation chain "model": rx_fm's full_demod as one step function.

Counterpart of :mod:`rx_tools_tpu.models.fmchain`.  Where the reference
drives a mutable ``struct demod_state`` through in-place C filters per
buffer (``full_demod``, ``src/rtl_fm.c:759-824``) plus capture-side
preprocessing in the read callback (``rtlsdr_callback``,
``rtl_fm.c:828-863``), the port is one function

    ``fm_chain_step(cfg, state, block) -> (state, audio, n_valid, level)``

over torch tensors on the state's device; every reference state field
lives in the :class:`FmState` NamedTuple (field for field the reference
package's, so states carry across, ``models/convert.py``).

Numerics: float32 in the reference's +/-128 8-bit range.  The boxcar head
runs in the capture-head kernel; the stateful heads (raw DC block ``-E
rdc``, fifth-order cascade and droop FIR ``-F 0|9``, polyphase FIR ``-F
>9``/``-E hq``, and the unaligned boxcar behind a raw DC block) and the
sinc resampler (``-E hq``) are plain torch ops, as they are plain XLA in
the reference package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.ops.fused_frontend import (fused_capture_fm_demod,
                                                   fused_eligible)
from rx_tools_tpu_torch.ops.numeric import device_const

MODES = ("fm", "am", "usb", "lsb", "raw")

#: reference buffer-geometry constants (rtl_fm.c:79-88)
DEFAULT_BUF_LENGTH = 16384
MAXIMUM_OVERSAMPLE = 16
MAXIMUM_BUF_LENGTH = MAXIMUM_OVERSAMPLE * DEFAULT_BUF_LENGTH
LCM_POST = [1, 1, 1, 3, 1, 5, 3, 7, 1, 9, 5, 11, 3, 13, 7, 15, 1]
FREQUENCIES_LIMIT = 1000

#: the capture rescale of the stateful heads, one float32 multiply
#: (``rtlsdr_callback``, rtl_fm.c:845-848)
_RESCALE = float(np.float32(128.0 / 32767.0))


@dataclass(frozen=True)
class FmConfig:
    """Static chain configuration (hashable)."""
    mode: str = "fm"
    rate_in: int = 24000           # demod input rate (post-capture-decim)
    rate_out: int = 24000
    rate_out2: int = -1            # audio resample target; <=0 disables
    downsample: int = 42           # capture decimation factor
    downsample_passes: int = 0     # 0 => boxcar; else fifth-order cascade
    comp_fir_size: int = 0         # 9 => droop compensation FIR
    custom_atan: int = 0           # DISC_* mode
    fir_quality: int = 0           # >9: windowed-sinc taps (ops.polyfir)
    resample_quality: int = 0      # >0: polyphase sinc resampler taps
    post_downsample: int = 1
    deemph_a: int = 0              # 0 disables
    dc_block_audio: bool = False
    dc_block_raw: bool = False
    squelch_level: float = 0.0
    squelch_zero: bool = False     # -E zero: emit zeros instead of hopping
    conseq_squelch: int = 10
    offset_tuning: bool = False
    output_scale: int = 1

    def audio_rate(self) -> int:
        """Final PCM rate: the resample target, else ``rate_out``."""
        return self.rate_out2 if self.rate_out2 > 0 else self.rate_out


class FmState(NamedTuple):
    """Carried DSP state — the functional twin of demod_state's mutable
    fields (rtl_fm.c:124-159); the reference package's field names."""
    dc_iq: torch.Tensor              # (2,) raw DC block averages
    boxcar: ops.BoxcarState
    fifth: ops.FifthOrderState       # (passes, 5, 2)
    droop: ops.DroopState            # (9, 2)
    prev_iq: torch.Tensor            # (2,) discriminator seam sample
    deemph_avg: torch.Tensor         # ()
    dc_avg: torch.Tensor             # ()
    resamp: ops.ResampleState
    squelch_hits: torch.Tensor       # () int32
    polyfir: ops.PolyFirState        # (taps-1, 2); dummy (1,2) when unused
    sincresamp: ops.SincResampleState  # (taps,) tail; dummy when unused


def init_state(cfg: FmConfig, device=None) -> FmState:
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return FmState(
        dc_iq=torch.zeros(2, dtype=torch.float32, device=dev),
        boxcar=ops.BoxcarState.init(dev),
        fifth=ops.FifthOrderState.init(max(cfg.downsample_passes, 1), dev),
        droop=ops.DroopState.init(dev),
        prev_iq=torch.zeros(2, dtype=torch.float32, device=dev),
        deemph_avg=zero,
        dc_avg=zero.clone(),
        resamp=ops.ResampleState.init(dev),
        # reference starts "muted": squelch_hits = 11 > conseq 10
        # (rtl_fm.c:1089-1091)
        squelch_hits=torch.full((), cfg.conseq_squelch + 1,
                                dtype=torch.int32, device=dev),
        polyfir=ops.PolyFirState.init(max(cfg.fir_quality, 2), dev),
        sincresamp=ops.SincResampleState.init(max(cfg.resample_quality, 2),
                                              dev),
    )


def block_samples(cfg: FmConfig, target: int | None = None) -> int:
    """Capture block size (complex samples) aligned to the whole chain:
    divisible by 4 (rotate), the decimation factor and the post-downsample
    step (ACTUAL_BUF_LENGTH, rtl_fm.c:1387, rounded to chain alignment)."""
    base = (target if target is not None
            else LCM_POST[cfg.post_downsample] * DEFAULT_BUF_LENGTH // 2)
    step = 4 * cfg.downsample * cfg.post_downsample
    return max(1, -(-base // step)) * step


def plan_capture(cfg: FmConfig, freq: float, edge: int = 0):
    """``optimal_settings`` analog (rtl_fm.c:960-997): the config with the
    capture decimation resolved, plus (capture_freq, capture_rate)."""
    downsample = (1_000_000 // cfg.rate_in) + 1
    passes = 0
    if cfg.downsample_passes:
        passes = int(math.log2(downsample)) + 1
        downsample = 1 << passes
    capture_rate = downsample * cfg.rate_in
    capture_freq = freq
    if not cfg.offset_tuning:
        capture_freq = freq + capture_rate / 4
    capture_freq += edge * cfg.rate_in / 2
    scale = (1 << 15) // (128 * downsample)
    scale = max(scale, 1)
    if cfg.mode == "fm":
        scale = 1
    cfg2 = dataclasses.replace(cfg, downsample=downsample,
                               downsample_passes=passes, output_scale=scale)
    return cfg2, capture_freq, capture_rate


def check_supported(cfg: FmConfig) -> None:
    """Raise for a mode the chain does not know."""
    if cfg.mode not in MODES:
        raise ValueError(cfg.mode)


def boxcar_head(cfg: FmConfig) -> bool:
    """True when the capture head is the stateless aligned boxcar (the
    capture-head kernel); otherwise :func:`stateful_head` runs."""
    return (not cfg.dc_block_raw and not cfg.downsample_passes
            and cfg.fir_quality <= 9)


def rescale_cs16(block: torch.Tensor) -> torch.Tensor:
    """(2N,) int16 -> (N, 2) float32 in the reference's 8-bit range."""
    return block.to(torch.float32).reshape(-1, 2) * _RESCALE


def stateful_head(cfg: FmConfig, state: FmState, block: torch.Tensor):
    """The capture head off the boxcar path (fmchain.py's non-boxcar
    branch of the reference, rtl_fm.c:763-779 and :845-863): rescale, raw
    DC block, fs/4 derotate, then the fifth-order cascade (+ droop FIR),
    the polyphase FIR or the aligned boxcar.  Returns the state with the
    head's carries updated and the planar ``(zi, zq)``."""
    dc_iq, fifth, droop, polyfir = (state.dc_iq, state.fifth, state.droop,
                                    state.polyfir)
    x = rescale_cs16(block)
    if cfg.dc_block_raw:
        dc_iq, x = ops.dc_block_raw(dc_iq, x)
    if not cfg.offset_tuning:
        x = ops.rotate_fs4(x)
    if cfg.downsample_passes:
        fifth, x = ops.fifth_order_cascade(fifth, x, cfg.downsample_passes)
        if cfg.comp_fir_size == 9:
            droop, x = ops.droop_fir(droop, x, cfg.downsample_passes)
    elif cfg.fir_quality > 9:
        taps = device_const(ops.design_lowpass, cfg.fir_quality,
                            1.0 / cfg.downsample, device=x.device)
        polyfir, x = ops.fir_decimate(polyfir, x, taps, cfg.downsample)
    else:
        # aligned boxcar: block_samples guarantees divisibility
        x = x.reshape(-1, cfg.downsample, 2).sum(dim=1)
    state = state._replace(dc_iq=dc_iq, fifth=fifth, droop=droop,
                           polyfir=polyfir)
    return state, x[:, 0].contiguous(), x[:, 1].contiguous()


def as_block(block, device: torch.device) -> torch.Tensor:
    """An int16 block (numpy or tensor) as a tensor on ``device``."""
    if isinstance(block, np.ndarray):
        # a read-only array (a file source's buffer) is copied once
        block = torch.from_numpy(np.require(block, requirements=("C", "W")))
    return block.to(device, non_blocking=True)


def _demod(cfg: FmConfig, prev_iq, zi, zq, seam_stride=None):
    """The demodulator of ``cfg.mode`` on planar I/Q; returns
    ``(prev_iq, audio)``."""
    if cfg.mode == "fm":
        return ops.fm_discriminate_planar(prev_iq, zi, zq, cfg.custom_atan,
                                          seam_stride=seam_stride)
    x = torch.stack([zi, zq], dim=-1)
    if cfg.mode == "am":
        return prev_iq, ops.am_demod(x, cfg.output_scale)
    if cfg.mode == "usb":
        return prev_iq, ops.usb_demod(x, cfg.output_scale)
    if cfg.mode == "lsb":
        return prev_iq, ops.lsb_demod(x, cfg.output_scale)
    return prev_iq, x.reshape(-1)                                 # raw


def fm_chain_step(cfg: FmConfig, state: FmState, block,
                  fused: bool | None = None):
    """One block through the whole chain.

    ``block``: (2N,) int16 interleaved CS16, N per :func:`block_samples`.
    Returns ``(state, audio, n_valid, level)``: float32 audio of fixed
    capacity (int16-range values), its valid prefix length (0-dim int32)
    and the squelch RMS level.  ``fused`` selects the one-kernel front
    (default: ``RX_FUSED``).
    """
    check_supported(cfg)
    dev = state.prev_iq.device
    block = as_block(block, dev)
    k_out = block.shape[0] // 2 // cfg.downsample
    rotate = not cfg.offset_tuning
    if fused_eligible(cfg, k_out, fused=fused):
        # one-kernel front: capture + fast-atan discriminator + level
        # partials; the std-atan2 seam at sample 0 (rtl_fm.c:588-590) is
        # computed in the kernel — semantics of the unfused path
        prev_iq, audio, levels = fused_capture_fm_demod(
            state.prev_iq, block, cfg.downsample, k_out, rotate=rotate)
        return _fm_post(cfg, state, audio, levels[0], prev_iq,
                        state.squelch_hits)
    if boxcar_head(cfg):
        # the boxcar chain head — rescale (rtl_fm.c:845-848), fs/4
        # derotate (rtl_fm.c:309-327), decimate (rtl_fm.c:351-371) — in
        # the capture-head kernel, planar output
        zi, zq = ops.capture_frontend_planar(block, cfg.downsample, rotate)
    else:
        state, zi, zq = stateful_head(cfg, state, block)

    # --- squelch (rtl_fm.c:781-790) ---
    level = ops.rms_level_planar(zi, zq)
    squelch_hits = state.squelch_hits
    if cfg.squelch_level > 0:
        squelched = level < cfg.squelch_level
        squelch_hits = torch.where(squelched, squelch_hits + 1,
                                   torch.zeros_like(squelch_hits))
        zi = torch.where(squelched, torch.zeros_like(zi), zi)
        zq = torch.where(squelched, torch.zeros_like(zq), zq)

    prev_iq, audio = _demod(cfg, state.prev_iq, zi, zq)
    if cfg.mode == "raw":
        return (state._replace(squelch_hits=squelch_hits), audio,
                _count(audio), level)
    return _fm_post(cfg, state, audio, level, prev_iq, squelch_hits)


def _count(audio: torch.Tensor) -> torch.Tensor:
    return torch.full((), audio.shape[0], dtype=torch.int32,
                      device=audio.device)


def _fm_post(cfg: FmConfig, state: FmState, audio, level, prev_iq,
             squelch_hits):
    """Audio post-processing + state assembly (rtl_fm.c:814-823), shared
    by the fused and unfused front paths."""
    if cfg.post_downsample > 1:
        audio = ops.low_pass_simple(audio, cfg.post_downsample)
    deemph_avg = state.deemph_avg
    if cfg.deemph_a:
        deemph_avg, audio = ops.deemph_filter(deemph_avg, audio, cfg.deemph_a)
    dc_avg = state.dc_avg
    if cfg.dc_block_audio:
        dc_avg, audio = ops.dc_block_audio(dc_avg, audio)
    resamp, sincresamp = state.resamp, state.sincresamp
    if cfg.rate_out2 > 0 and cfg.resample_quality > 0:
        sincresamp, audio, n_valid = ops.resample_sinc(
            sincresamp, audio, cfg.rate_out, cfg.rate_out2,
            taps=cfg.resample_quality)
    elif cfg.rate_out2 > 0:
        resamp, audio, n_valid = ops.resample_rational(
            resamp, audio, cfg.rate_out, cfg.rate_out2)
    else:
        n_valid = _count(audio)
    new_state = state._replace(prev_iq=prev_iq, deemph_avg=deemph_avg,
                               dc_avg=dc_avg, resamp=resamp,
                               squelch_hits=squelch_hits,
                               sincresamp=sincresamp)
    return new_state, audio, n_valid, level


def audio_to_int16(audio: np.ndarray) -> np.ndarray:
    """Host-side emit: float audio -> int16 PCM (C truncation)."""
    return np.trunc(np.clip(audio, -32768, 32767)).astype(np.int16)


def wbfm_preset(rate_out2: int = 32000) -> FmConfig:
    """The ``-M wbfm`` macro preset (rtl_fm.c:1331-1341): 170k in, fast
    atan, deemphasis on, resample to 32k, squelch off."""
    return FmConfig(mode="fm", rate_in=170000, rate_out=170000,
                    rate_out2=rate_out2, custom_atan=ops.DISC_FAST,
                    deemph_a=ops.deemph_alpha(170000, 75), squelch_level=0.0)
