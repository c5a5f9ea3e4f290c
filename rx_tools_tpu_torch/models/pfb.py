"""Polyphase filterbank (PFB) channelizer: D uniform channels at once.

Counterpart of :mod:`rx_tools_tpu.models.pfb`.  When the stations sit on a
uniform grid, the critically sampled PFB computes all D channels of a
wideband capture together,

    y[m, c] = sum_n h[n] * x[m*D - n] * exp(-j*2*pi*c*n/D),

as (1) a length-T FIR over the stride-D polyphase branches and (2) one
D-point inverse DFT across the branch axis per output step.  Channel c is
centred at +c*fs/D (c >= D/2 alias to negative offsets); the stopband is
the Kaiser prototype's.

Three forms of the filterbank, as in the reference package:

- :func:`filterbank`: the branch FIR as T shifted multiply-adds per
  (branch, component) row in the order of the reference's correlation,
  then ``torch.fft.ifft`` (cuFFT on the card);
- :func:`filterbank_mxu`: the same FIR (:func:`_fb_pre_mxu`), then the
  branch reversal, inverse DFT, gain and I/Q de-interleave as one
  ``(2D, 2D) @ (2D, M)`` float32 product;
- :func:`filterbank_tmaj`: that product transposed, time-major, with one
  extra output frame so the discriminator's previous sample is a row
  offset (:func:`pfb_step_tmaj`).

The per-channel demod tail is the mixer channelizer's
(``channelizer.demod_tail_batch_planar``) or, time-major, :mod:`.tmaj`'s.
Raw output stays on the channel-major engine: :func:`pfb_step_tmaj`
refuses ``mode="raw"``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models import channelizer as _chan
from rx_tools_tpu_torch.models.channelizer import (_resamp0, _tmaj_demod,
                                                   _tmaj_tail, _zeros)
from rx_tools_tpu_torch.models.fmchain import as_block
from rx_tools_tpu_torch.models.tmaj import (  # noqa: F401  (re-exported)
    _iir_tmaj, _resample_tmaj, _resample_tmaj_periodic)
from rx_tools_tpu_torch.ops.numeric import device_const, fp32_products
from rx_tools_tpu_torch.ops.polyfir import design_lowpass
from rx_tools_tpu_torch.ops.resample import ResampleState

_RESCALE = float(np.float32(128.0 / 32767.0))


@dataclass(frozen=True)
class PfbConfig:
    """Static config: D uniform channels == decimation factor D."""
    capture_rate: int
    n_channels: int                  # D: channel count == decimation
    taps_per_branch: int = 8         # T: prototype length is T*D
    mode: str = "fm"
    custom_atan: int = 0
    deemph_a: int = 0
    rate_out2: int = -1              # per-channel audio resample target
    output_scale: int = 1
    beta: float = 8.6                # Kaiser prototype shape

    @property
    def channel_rate(self) -> int:
        return self.capture_rate // self.n_channels

    def channel_freqs(self, center: float = 0.0):
        """Channel centre frequencies (Hz offsets from the capture centre);
        channel c sits at +c*fs/D, c >= D/2 wraps negative."""
        d = self.n_channels
        fs = self.capture_rate
        return [center + (c if c < d / 2 else c - d) * fs / d
                for c in range(d)]


class PfbState(NamedTuple):
    tail: torch.Tensor             # (T*D, 2) trailing input samples
    prev_iq: torch.Tensor          # (D, 2) per-channel discriminator seam
    deemph_avg: torch.Tensor       # (D,)
    resamp: ResampleState          # (D,) acc / phase


def init_state(cfg: PfbConfig, device=None) -> PfbState:
    dev = resolve_device(device)
    d, t = cfg.n_channels, cfg.taps_per_branch
    return PfbState(tail=_zeros((t * d, 2), dev), prev_iq=_zeros((d, 2), dev),
                    deemph_avg=_zeros(d, dev), resamp=_resamp0(d, dev))


def block_samples(cfg: PfbConfig, target: int = 131072) -> int:
    """Block size (complex samples) aligned to the channel count."""
    step = cfg.n_channels
    return max(1, -(-target // step)) * step


def _prototype(cfg: PfbConfig) -> np.ndarray:
    """Kaiser-sinc prototype, cutoff = one channel width (fs/D)."""
    return design_lowpass(cfg.taps_per_branch * cfg.n_channels,
                          1.0 / cfg.n_channels, cfg.beta)


@functools.lru_cache(maxsize=16)
def _branch_taps(taps: int, d: int, beta: float) -> np.ndarray:
    """(T, 2D) branch-FIR taps, column 2q+c for branch q, component c, row
    ``tt`` weighting frame ``m + tt``: ``hb[tt] = hp2[T-1-tt]`` with
    ``hp2[t, q] = h[(T-1-t)*D + (D-1-q)]`` (so that ``sum_tt Y[m+tt] *
    hb[tt]`` realises ``sum_n h[n] x[mD - n]``)."""
    h = design_lowpass(taps * d, 1.0 / d, beta)
    hp2 = h.reshape(taps, d)[::-1, ::-1]
    return np.ascontiguousarray(np.repeat(hp2, 2, axis=1)[::-1])


def _taps(cfg: PfbConfig, dev) -> torch.Tensor:
    return device_const(_branch_taps, cfg.taps_per_branch, cfg.n_channels,
                        float(cfg.beta), device=dev)


def filterbank(cfg: PfbConfig, tail, block):
    """The filterbank front half: block -> ``(new_tail, zi (D, M), zq (D,
    M))``; ``tail`` (T*D, 2) the carried input history."""
    fp32_products()
    d, t = cfg.n_channels, cfg.taps_per_branch
    x = as_block(block, tail.device).to(torch.float32).reshape(-1, 2) \
        * _RESCALE
    n = x.shape[0]
    assert n % d == 0, (n, d)
    m = n // d
    xp = torch.cat([tail, x], dim=0)                        # (T*D + N, 2)
    # polyphase frames: Y[k, q] = xp[k*D + 1 + q], k = 0 .. M+T-2, laid out
    # (branch-component row 2q+c, frame)
    lhs = xp[1: 1 + (m + t - 1) * d].reshape(m + t - 1, 2 * d).T
    # the depthwise correlation with the tap-reversed kernel, tap by tap
    hb = _taps(cfg, x.device)                               # (T, 2D)
    w = lhs[:, 0:m] * hb[0][:, None]
    for k in range(1, t):
        w = w + lhs[:, k:k + m] * hb[k][:, None]            # (2D, M)
    w3 = w.reshape(d, 2, m)
    # u[p] = W[D-1-p]; channel c = sum_p u[p] e^{+j2pi c p/D}: ifft * D,
    # and the extra D matches the mixer channelizer's boxcar gain
    u = torch.complex(w3[:, 0].flip(0), w3[:, 1].flip(0)) * float(d)
    ch = torch.fft.ifft(u, dim=0) * float(d)                # (D, M)
    return xp[-(t * d):], ch.real.contiguous(), ch.imag.contiguous()


@functools.lru_cache(maxsize=16)
def _dft_matrix(d: int) -> np.ndarray:
    """(2D, 2D) real matrix folding the branch reversal, the D-point
    inverse DFT and the x D gain over interleaved branch columns: row c in
    [0, D) is Re(channel c), row D+c is Im; column 2q+c' is branch q,
    component c'."""
    q = np.arange(d)
    th = 2 * np.pi * np.outer(np.arange(d), (d - 1 - q)) / d   # (C, Q)
    m = np.zeros((2 * d, 2 * d), np.float32)
    m[:d, 0::2] = d * np.cos(th)
    m[:d, 1::2] = -d * np.sin(th)
    m[d:, 0::2] = d * np.sin(th)
    m[d:, 1::2] = d * np.cos(th)
    return m


def _fb_pre_mxu(cfg: PfbConfig, tail, block):
    """The branch-FIR half of :func:`filterbank_mxu`:
    ``block -> (new_tail, w (2D, M))``."""
    d, t = cfg.n_channels, cfg.taps_per_branch
    dev = tail.device
    block = as_block(block, dev)
    n = block.shape[0] // 2
    assert n % d == 0, (n, d)
    m = n // d
    y = block.to(torch.float32) * _RESCALE
    xp_flat = torch.cat([tail.reshape(-1), y])              # (2(T*D+N),)
    hb = _taps(cfg, dev)
    # frames[k, 2q+c] = xp[k*D + 1 + q][c]  (the framing of filterbank)
    ft = xp_flat[2: 2 + (m + t - 1) * 2 * d].reshape(m + t - 1, 2 * d).T
    w = ft[:, :m] * hb[0][:, None]
    for tt in range(1, t):
        w = w + ft[:, tt:tt + m] * hb[tt][:, None]          # (2D, M)
    return xp_flat[-(2 * t * d):].reshape(t * d, 2), w


def filterbank_mxu(cfg: PfbConfig, tail, block):
    """The product form of :func:`filterbank` (same semantics): the branch
    FIR as T shifted multiply-adds, the DFT and de-interleave as one
    ``(2D, 2D) @ (2D, M)`` float32 product."""
    fp32_products()
    d = cfg.n_channels
    new_tail, w = _fb_pre_mxu(cfg, tail, block)
    ch = device_const(_dft_matrix, d, device=w.device) @ w
    return new_tail, ch[:d], ch[d:]


# ---------------------------------------------------------------------------
# the time-major formulation
# ---------------------------------------------------------------------------

class PfbStateTM(NamedTuple):
    """Carried state of :func:`pfb_step_tmaj`: ``tailx`` holds the last
    ``(T+1)*D`` input samples, flat interleaved float32, one frame more
    than the channel-major state, so the filterbank emits the previous
    block's last frame again and the discriminator's previous sample is a
    row of the filterbank's own output."""
    tailx: torch.Tensor            # (2*(T+1)*D,) flat interleaved f32
    deemph_avg: torch.Tensor       # (D,)
    resamp: ResampleState          # (D,) acc / phase


def init_state_tmaj(cfg: PfbConfig, device=None) -> PfbStateTM:
    dev = resolve_device(device)
    d, t = cfg.n_channels, cfg.taps_per_branch
    return PfbStateTM(tailx=_zeros(2 * (t + 1) * d, dev),
                      deemph_avg=_zeros(d, dev), resamp=_resamp0(d, dev))


def filterbank_tmaj(cfg: PfbConfig, tailx, block):
    """Time-major filterbank: block -> ``(new_tailx, ch2 (M+1, 2D))``,
    columns [Re ch 0..D-1 | Im ch 0..D-1]; row 0 re-derives the previous
    block's last frame from the carried tail."""
    fp32_products()
    d, t = cfg.n_channels, cfg.taps_per_branch
    dev = tailx.device
    block = as_block(block, dev)
    n = block.shape[0] // 2
    assert n % d == 0, (n, d)
    m = n // d
    xp = torch.cat([tailx, block.to(torch.float32) * _RESCALE])
    hb = _taps(cfg, dev)
    # frames2[k, 2q+c] = xp_c[k*D + 1 + q][c], k = 0..M+T-1
    f2 = xp[2: 2 + (m + t) * 2 * d].reshape(m + t, 2 * d)
    w = f2[0: m + 1] * hb[0][None, :]
    for tt in range(1, t):
        w = w + f2[tt: tt + m + 1] * hb[tt][None, :]        # (M+1, 2D)
    ch2 = w @ device_const(_dft_matrix, d, device=dev).T
    return xp[-(2 * (t + 1) * d):], ch2


def pfb_step_tmaj(cfg: PfbConfig, state: PfbStateTM, block):
    """Time-major PFB step: one wideband block -> D channels demodulated,
    ``(state, audio (cap, D), n_valid ())`` (``audio.T`` is the
    channel-major layout).  Same per-channel semantics as :func:`pfb_step`.

    Raw output is refused: the channel-major engine (:func:`pfb_step`)
    serves it, interleaved per channel (the reference package returns the
    packed [Re | Im] matrix here, ADVICE.md:4)."""
    d = cfg.n_channels
    if cfg.mode == "raw":
        raise ValueError("pfb_step_tmaj does not serve mode='raw'; use the "
                         "channel-major pfb_step")
    if ((block.shape[-1] // 2 // d) % 128 != 0
            and (cfg.deemph_a or cfg.rate_out2 > 0)):
        raise ValueError(
            f"pfb_step_tmaj needs per-channel block length divisible by "
            f"128 (got {block.shape[-1] // 2 // d}); pick a block of "
            f"128*{d}*k complex samples (block_samples default is fine)")
    tailx, ch2 = filterbank_tmaj(cfg, state.tailx, block)
    cur, prev = ch2[1:], ch2[:-1]                          # (M, 2D)
    dd = _tmaj_demod(cfg, cur[:, :d], cur[:, d:], prev[:, :d], prev[:, d:])
    davg, resamp, audio, nv = _tmaj_tail(cfg, state.deemph_avg, state.resamp,
                                         dd)
    return PfbStateTM(tailx, davg, resamp), audio, nv


def pfb_scan_blocks_tmaj(cfg: PfbConfig, state: PfbStateTM, blocks):
    """``B`` chained :func:`pfb_step_tmaj` calls: ``blocks`` (B, 2N) ->
    ``(state, audio (B, cap, D), n_valid (B,))``, the per-block steps
    themselves (so the bytes equal per-block dispatch's)."""
    blocks = as_block(blocks, state.tailx.device)
    audio, nv = [], []
    for i in range(blocks.shape[0]):
        state, a, v = pfb_step_tmaj(cfg, state, blocks[i])
        audio.append(a)
        nv.append(v)
    return state, torch.stack(audio), torch.stack(nv)


def pfb_step(cfg: PfbConfig, state: PfbState, block):
    """One wideband block -> D channels demodulated: ``block`` (2N,) int16,
    N % D == 0 -> ``(state, audio (D, cap), n_valid (D,))``, the contract
    of ``channelizer.channelize_step``."""
    tail, zi, zq = filterbank_mxu(cfg, state.tail, block)
    prev, davg, racc, rphase, audio, n_valid = _chan.demod_tail_batch_planar(
        cfg, state.prev_iq, state.deemph_avg, state.resamp.acc,
        state.resamp.phase, zi, zq)
    return (PfbState(tail=tail, prev_iq=prev, deemph_avg=davg,
                     resamp=ResampleState(racc, rphase)),
            audio, n_valid)
