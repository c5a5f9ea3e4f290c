"""``--int-audio``: the bit-exact integer FM/AM/SSB chain (models layer).

Counterpart of :mod:`rx_tools_tpu.models.fmint`: the oracle's
``full_demod`` (``tests/oracles/c_ref.py``, ``rtl_fm.c:759-824``) on the
boxcar path, in int64 tensors on the state's device.  The per-buffer
std-atan2 seam (``fm_demod``, rtl_fm.c:588-590) is the one stage computed
on the host (Python float64 atan2, the C's double math); the device step
emits the seam's integer inputs and a placeholder, and
:func:`int_chain_block` rewrites sample 0 with :func:`seam_value`.

Covers: fm (-A fast/lut/ale), am, usb, lsb; post-downsample; deemph (the
``int_deemph`` kernel on the card); audio DC block; the rational
resampler.  Not covered (the float plane serves them): -A std, the
fifth-order -F path, the polyphase FIR and sinc resampler, squelch, raw DC.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models.fmchain import as_block
from rx_tools_tpu_torch.ops import intaudio
from rx_tools_tpu_torch.ops.rotate import rotate_fs4


class IntFmState(NamedTuple):
    pre_r: torch.Tensor        # () carried discriminator pair
    pre_j: torch.Tensor
    deemph_avg: torch.Tensor   # () integer deemph state
    dc_avg: torch.Tensor       # () audio DC EMA
    now_lpr: torch.Tensor      # () resampler window accumulator
    lpr_phase: torch.Tensor    # () resampler phase (reduced units)


def init_state(device=None) -> IntFmState:
    dev = resolve_device(device)
    return IntFmState(*(torch.zeros((), dtype=torch.int64, device=dev)
                        for _ in IntFmState._fields))


def supports(cfg) -> bool:
    """Configs the integer tier covers bit-exactly."""
    return (cfg.mode in ("fm", "am", "usb", "lsb")
            and not cfg.downsample_passes and cfg.fir_quality <= 9
            and cfg.resample_quality == 0
            and not cfg.dc_block_raw and cfg.squelch_level == 0
            and (cfg.mode != "fm" or cfg.custom_atan in (1, 2, 3)))


def _step(cfg, state: IntFmState, block_i16: torch.Tensor):
    lp = intaudio.rescale_int(block_i16).reshape(-1, 2)
    if not cfg.offset_tuning:
        lp = rotate_fs4(lp)
    z = intaudio.boxcar_int(lp, cfg.downsample)
    zi, zq = z[:, 0], z[:, 1]
    seam = None
    if cfg.mode == "fm":
        pre = torch.stack([state.pre_r, state.pre_j])
        pre, result, seam = intaudio.fm_demod_int(pre, zi, zq,
                                                  cfg.custom_atan)
        state = state._replace(pre_r=pre[0], pre_j=pre[1])
    elif cfg.mode == "am":
        result = intaudio.am_demod_int(zi, zq, cfg.output_scale)
    elif cfg.mode == "usb":
        result = intaudio._i16(intaudio._i16(zi + zq) * cfg.output_scale)
    else:
        result = intaudio._i16(intaudio._i16(zi - zq) * cfg.output_scale)
    return state, result, seam


def _post(cfg, state: IntFmState, result: torch.Tensor):
    if cfg.post_downsample > 1:
        result = intaudio.low_pass_simple_int(result, cfg.post_downsample)
    deemph_avg = state.deemph_avg
    if cfg.deemph_a:
        deemph_avg, result = intaudio.deemph_int(deemph_avg, result,
                                                 cfg.deemph_a)
    dc_avg = state.dc_avg
    if cfg.dc_block_audio:
        dc_avg, result = intaudio.dc_block_audio_int(dc_avg, result)
    now, phase = state.now_lpr, state.lpr_phase
    if cfg.rate_out2 > 0:
        now, phase, result, n_valid = intaudio.low_pass_real_int(
            now, phase, result, cfg.rate_out, cfg.rate_out2)
    else:
        n_valid = result.shape[0]
    return (state._replace(deemph_avg=deemph_avg, dc_avg=dc_avg,
                           now_lpr=now, lpr_phase=phase),
            result, n_valid)


def seam_value(seam) -> int:
    """Host float64 std-atan2 of the seam sample (``polar_discriminant``,
    rtl_fm.c:476-483) from its four integer inputs, int16-wrapped — exact
    against the C's double math."""
    ai, aj, br, bj = (int(v) for v in seam)
    cr = ai * br + aj * bj
    cj = aj * br - ai * bj
    angle = math.atan2(float(cj), float(cr))
    v = int(math.trunc(angle / 3.14159 * (1 << 14)))
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def demod_block(cfg, state: IntFmState, block_i16):
    """One block's device demod and host seam patch: ``(state, result)``,
    the int16-valued samples the audio post takes."""
    block = as_block(block_i16, state.pre_r.device)
    st, result, seam = _step(cfg, state, block)
    if seam is not None:
        result = result.clone()
        result[0] = seam_value(seam.tolist())
    return st, result


def int_chain_block(cfg, state: IntFmState, block_i16):
    """One block through the bit-exact integer chain: device demod, host
    seam patch, device audio post.  Returns ``(state, audio int16
    np.ndarray)``."""
    st, result = demod_block(cfg, state, block_i16)
    st, audio, n_valid = _post(cfg, st, result)
    return st, audio[: int(n_valid)].cpu().numpy().astype(np.int16)
