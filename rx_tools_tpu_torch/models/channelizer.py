"""Multi-channel demodulation: many stations from one wideband capture.

Counterpart of :mod:`rx_tools_tpu.models.channelizer`.  The reference
demodulates one channel per process per dongle (``src/rtl_fm.c:189-193``
"multiple of these, eventually"); this mixes every station down at once.
Two engines, arbitrary station offsets:

- :func:`channelize_step` (channel-major, float NCO): mixes a ``(C, N)``
  per-channel rotation, boxcar-decimates, runs the batched planar demod
  tail (the per-channel half of ``full_demod``, ``rtl_fm.c:808-823``).
- :func:`channelize_step_tmaj` (time-major, integer NCO): the mix folds
  into the decimation window, ``e^{-jw(mD+j)} = e^{-jwmD} e^{-jwj}``, so
  mix and decimate are one ``(M, 2D) @ (2D, 2C)`` float32 product against
  a fixed matrix, then an M-rate phasor whose phase numerators are exact
  int32 arithmetic mod fs; the tail is the time-major one of
  :mod:`.tmaj` (triangular-product de-emphasis, periodic-mask resampler).

Plain functions on tensors on the state's device; the matrix products run
in full float32 (TF32 off, the reference's ``Precision.HIGHEST``).  No
hand-written kernel: the reference package reaches no Pallas kernel here.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models import tmaj
from rx_tools_tpu_torch.models.fmchain import as_block, rescale_cs16
from rx_tools_tpu_torch.models.stepgraph import graphed
from rx_tools_tpu_torch.ops.discriminators import _lut_products
from rx_tools_tpu_torch.ops.numeric import device_const, fp32_products
from rx_tools_tpu_torch.ops.resample import (ResampleState, resample_rational,
                                             resample_rational_batch)

_RESCALE = float(np.float32(128.0 / 32767.0))
_TWO_PI = float(np.float32(2.0 * math.pi))


@dataclass(frozen=True)
class ChannelizerConfig:
    """Static config: one wideband input, C identical-mode channels."""
    capture_rate: int                 # wideband fs
    offsets: tuple                    # per-channel offset from capture center (Hz)
    downsample: int                   # capture -> channel rate decimation
    mode: str = "fm"
    custom_atan: int = 1
    deemph_a: int = 0
    rate_out2: int = -1               # audio resample target per channel
    output_scale: int = 1

    @property
    def channel_rate(self) -> int:
        return self.capture_rate // self.downsample

    @property
    def n_channels(self) -> int:
        return len(self.offsets)


class ChannelizerState(NamedTuple):
    nco_phase: torch.Tensor           # (C,) carried mix phase (radians)
    prev_iq: torch.Tensor             # (C, 2) discriminator seam
    deemph_avg: torch.Tensor          # (C,)
    resamp: ResampleState             # leaves shaped (C,)
    sample_index: torch.Tensor        # () int32 absolute block counter


def _zeros(shape, dev, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)


def _resamp0(c: int, dev) -> ResampleState:
    return ResampleState(_zeros(c, dev), _zeros(c, dev, torch.int32))


def init_state(cfg: ChannelizerConfig, device=None) -> ChannelizerState:
    dev = resolve_device(device)
    c = cfg.n_channels
    return ChannelizerState(
        nco_phase=_zeros(c, dev), prev_iq=_zeros((c, 2), dev),
        deemph_avg=_zeros(c, dev), resamp=_resamp0(c, dev),
        sample_index=_zeros((), dev, torch.int32))


def block_samples(cfg: ChannelizerConfig, target: int = 65536) -> int:
    step = 4 * cfg.downsample
    return max(1, -(-target // step)) * step


def _count(n: int, dev, shape=()) -> torch.Tensor:
    return torch.full(shape, n, dtype=torch.int32, device=dev)


def demod_tail(cfg, prev, davg, racc, rphase, zc):
    """One channel's demod tail (``full_demod``'s post-decimation half,
    ``src/rtl_fm.c:808-823``): discriminate/detect -> deemph -> resample.
    ``zc`` (M, 2); ``cfg`` duck-types ``mode / custom_atan / output_scale /
    deemph_a / channel_rate / rate_out2`` (both channelizers' configs)."""
    dev = zc.device
    if cfg.mode == "raw":
        audio = zc.reshape(-1)
        return prev, davg, racc, rphase, audio, _count(audio.shape[0], dev)
    if cfg.mode == "fm":
        prev, audio = ops.fm_discriminate(prev, zc, cfg.custom_atan)
    elif cfg.mode == "am":
        audio = ops.am_demod(zc, cfg.output_scale)
    elif cfg.mode == "usb":
        audio = ops.usb_demod(zc, cfg.output_scale)
    elif cfg.mode == "lsb":
        audio = ops.lsb_demod(zc, cfg.output_scale)
    else:
        raise ValueError(cfg.mode)
    if cfg.deemph_a:
        davg, audio = ops.deemph_filter(davg, audio, cfg.deemph_a)
    if cfg.rate_out2 > 0:
        rst, audio, nv = resample_rational(
            ResampleState(racc, rphase), audio, cfg.channel_rate,
            cfg.rate_out2)
        racc, rphase = rst.acc, rst.phase
    else:
        nv = _count(audio.shape[0], dev)
    return prev, davg, racc, rphase, audio, nv


def demod_tail_batch(cfg, prev, davg, racc, rphase, z):
    """:func:`demod_tail` over the channel axis: ``z`` (C, M, 2)."""
    if cfg.mode == "raw":
        c_ch = z.shape[0]
        audio = z.reshape(c_ch, -1)
        return (prev, davg, racc, rphase, audio,
                _count(audio.shape[1], z.device, (c_ch,)))
    return demod_tail_batch_planar(cfg, prev, davg, racc, rphase,
                                   z[..., 0], z[..., 1])


def demod_tail_batch_planar(cfg, prev, davg, racc, rphase, zi, zq):
    """Planar batched demod tail: ``zi``/``zq`` (C, M).  Every stage is one
    batched op: the discriminator's seam a concatenate, the de-emphasis a
    scan along axis -1, the resampler one shared emission grid.  Returns
    ``(prev, davg, racc, rphase, audio (C, cap), n_valid (C,))``."""
    c_ch, dev = zi.shape[0], zi.device
    if cfg.mode == "fm":
        prev, audio = ops.fm_discriminate_batch_planar(prev, zi, zq,
                                                       cfg.custom_atan)
    elif cfg.mode == "raw":
        audio = torch.stack([zi, zq], dim=-1).reshape(c_ch, -1)
        return (prev, davg, racc, rphase, audio,
                _count(audio.shape[1], dev, (c_ch,)))
    else:
        audio = _detect(cfg, zi, zq)
    if cfg.deemph_a:
        davg, audio = ops.deemph_filter(davg, audio, cfg.deemph_a, axis=-1)
    if cfg.rate_out2 > 0:
        rst, audio, nv = resample_rational_batch(
            ResampleState(racc, rphase), audio, cfg.channel_rate,
            cfg.rate_out2)
        racc, rphase = rst.acc, rst.phase
        n_valid = nv.expand(c_ch).contiguous()
    else:
        n_valid = _count(audio.shape[1], dev, (c_ch,))
    return prev, davg, racc, rphase, audio, n_valid


# ---------------------------------------------------------------------------
# the time-major mixer: integer NCO, mix folded into the decimation window
# ---------------------------------------------------------------------------

class ChannelizerStateTM(NamedTuple):
    """Carried state of :func:`channelize_step_tmaj`: the NCO phase is an
    exact integer cycle fraction (the numerator of phase/2pi in units of
    1/capture_rate), so long runs never drift."""
    nco_num: torch.Tensor          # (C,) int32: phase numerator mod fs
    prev_iq: torch.Tensor          # (C, 2) discriminator seam
    deemph_avg: torch.Tensor       # (C,)
    resamp: ResampleState          # (C,) acc / phase


def init_state_tmaj(cfg: ChannelizerConfig, device=None) -> ChannelizerStateTM:
    dev = resolve_device(device)
    c = cfg.n_channels
    return ChannelizerStateTM(
        nco_num=_zeros(c, dev, torch.int32), prev_iq=_zeros((c, 2), dev),
        deemph_avg=_zeros(c, dev), resamp=_resamp0(c, dev))


def tmaj_supported(cfg: ChannelizerConfig, block_size: int) -> bool:
    """Integer-Hz offsets (the NCO arithmetic is exact integer mod fs), a
    non-raw mode, and a 128-aligned channel-rate block (the time-major
    tail's batched scans)."""
    return (all(float(o).is_integer() for o in cfg.offsets)
            and cfg.mode in ("fm", "am", "usb", "lsb")
            and (block_size // cfg.downsample) % 128 == 0)


@functools.lru_cache(maxsize=16)
def _mix_decim_matrix(offsets: tuple, d: int, fs: int) -> np.ndarray:
    """(2D, 2C) real matrix: one product mixes and boxcar-decimates every
    channel, ``inner[m, c] = sum_j (xi + j*xq)[mD+j] * e^{-j w_c j}``.
    Column c is Re(inner), column C+c is Im; row 2j weights xi, 2j+1 xq.
    Built in float64 on the host."""
    c = len(offsets)
    m = np.zeros((2 * d, 2 * c), np.float32)
    for ci, off in enumerate(offsets):
        w = 2.0 * np.pi * (float(off) / fs) * np.arange(d)
        m[0::2, ci] = np.cos(w)
        m[1::2, ci] = np.sin(w)
        m[0::2, c + ci] = -np.sin(w)
        m[1::2, c + ci] = np.cos(w)
    return m


def _nco_split(m: int) -> tuple[int, int]:
    """``(U, V)``: the ``m = u*U + v`` split of the decimated rows, U a
    power of two near sqrt(M)."""
    u_sz = 1 << max(1, (m - 1).bit_length() // 2)
    return u_sz, -(-m // u_sz)


@functools.lru_cache(maxsize=16)
def _nco_base(offsets: tuple, fs: int, d: int, m: int) -> np.ndarray:
    """(M, C) int32: ``(off_c*D*row) mod fs`` for the decimated rows,
    summed from the ``u*U + v`` split as ``(off*D*U mod fs)*u mod fs +
    (off*D mod fs)*v mod fs`` (each term below fs, every product below
    2**31 under the step's guard)."""
    offs = np.asarray([int(o) for o in offsets], np.int64)
    u_sz, u_n = _nco_split(m)
    off_d = (offs * d) % fs
    off_du = (off_d * u_sz) % fs
    u = np.arange(u_n, dtype=np.int64)[:, None, None]
    v = np.arange(u_sz, dtype=np.int64)[None, :, None]
    base = (off_du * u) % fs + (off_d * v) % fs                # (U, V, C)
    return base.reshape(-1, len(offs))[:m].astype(np.int32)


@functools.lru_cache(maxsize=16)
def _nco_advance(offsets: tuple, fs: int, n: int) -> np.ndarray:
    """(C,) int32: the NCO numerator's advance over one N-sample block."""
    offs = np.asarray([int(o) for o in offsets], np.int64)
    return ((offs * n) % fs).astype(np.int32)


def _nco_phasor_rows(offsets: tuple, fs: int, d: int, num0: torch.Tensor,
                     m: int):
    """cos/sin of ``-2pi*((off_c*D*row + num0_c) mod fs)/fs`` for the M
    decimated rows, (M, C) each.  The numerators are exact int32
    arithmetic; the angle stays below 2pi."""
    base = device_const(_nco_base, offsets, fs, d, m, device=num0.device)
    num = (base + num0[None, :]) % fs                          # int32
    th = num.to(torch.float32) * float(np.float32(-2.0 * math.pi / fs))
    return torch.cos(th), torch.sin(th)


def _detect(cfg, ar, aj):
    """The AM/USB/LSB detector of planar I/Q (any layout): envelope, I+Q
    or I-Q, times ``output_scale``."""
    scale = float(cfg.output_scale)
    if cfg.mode == "am":
        return torch.sqrt(ar * ar + aj * aj) * scale
    if cfg.mode == "usb":
        return (ar + aj) * scale
    if cfg.mode == "lsb":
        return (ar - aj) * scale
    raise ValueError(cfg.mode)


def _tmaj_demod(cfg, ar, aj, br, bj):
    """The time-major demod of the rows ``(ar, aj)`` (M, C), ``(br, bj)``
    each row's previous sample (used by FM only): the discriminator (std
    atan seam at row 0, rtl_fm.c:588-590) or the detector.  Both
    channelizers' time-major steps run it."""
    if cfg.mode == "fm":
        return _tmaj_disc(cfg.custom_atan, ar, aj, br, bj)
    return _detect(cfg, ar, aj)


def _tmaj_disc(mode: int, ar, aj, br, bj):
    """Discriminator of ``a * conj(b)`` row by row, (M, C); row 0 through
    the std atan2 whatever the mode."""
    cr = ar * br + aj * bj
    cj = aj * br - ar * bj
    if mode == ops.DISC_STD:
        return ops.polar_discriminant(cr, cj)
    if mode == ops.DISC_FAST:
        dd = ops.polar_disc_fast(cr, cj)
    elif mode == ops.DISC_LUT:
        dd = ops.polar_disc_lut(*_lut_products(ar, aj, br, bj))
    elif mode == ops.DISC_ALE:
        dd = ops.esbensen_disc(ar, aj, br, bj)
    else:
        raise ValueError(f"bad discriminator mode {mode}")
    dd[0] = ops.polar_discriminant(cr[0], cj[0])
    return dd


def _tmaj_tail(cfg, davg, resamp: ResampleState, dd):
    """De-emphasis and audio resampler of a time-major (M, C) stack:
    ``(davg, resamp, audio (cap, C), n_valid ())``."""
    if cfg.deemph_a:
        inv_a = 1.0 / cfg.deemph_a
        davg, dd = tmaj._iir_tmaj(davg, dd * float(np.float32(inv_a)),
                                  1.0 - inv_a)
    if cfg.rate_out2 > 0:
        resamp, dd, nv = tmaj.resample_tmaj(resamp, dd, cfg.channel_rate,
                                            cfg.rate_out2)
    else:
        nv = _count(dd.shape[0], dd.device)
    return davg, resamp, dd, nv


@graphed
def channelize_step_tmaj(cfg: ChannelizerConfig, state: ChannelizerStateTM,
                         block):
    """Time-major mixer step: ``block`` (2N,) int16 ->
    ``(state, audio (cap, C), n_valid ())``, the arbitrary-offset twin of
    ``pfb.pfb_step_tmaj`` (same output contract).  Gate on
    :func:`tmaj_supported`.  On the card a call replays a CUDA graph of
    the step (:mod:`.stepgraph`)."""
    fp32_products()
    dev = state.nco_num.device
    block = as_block(block, dev)
    offsets = tuple(cfg.offsets)
    c = cfg.n_channels
    d = cfg.downsample
    fs = int(cfg.capture_rate)
    n = block.shape[0] // 2
    m = n // d
    u_sz, _ = _nco_split(m)
    if fs * (u_sz + m // u_sz + 2) >= 2 ** 31:
        raise ValueError("block too large for the int32 NCO decomposition")

    # mix + boxcar-decimate every channel: one product
    frames = block.to(torch.float32).reshape(m, 2 * d) * _RESCALE
    inner = frames @ device_const(_mix_decim_matrix, offsets, d, fs,
                                  device=dev)
    ire, iim = inner[:, :c], inner[:, c:]                      # (M, C)
    ca, sa = _nco_phasor_rows(offsets, fs, d, state.nco_num, m)
    zi = ca * ire - sa * iim
    zq = sa * ire + ca * iim
    nco_num = (state.nco_num
               + device_const(_nco_advance, offsets, fs, n, device=dev)) % fs

    br = bj = None
    if cfg.mode == "fm":          # the seam: the previous decimated row
        br = torch.cat([state.prev_iq[None, :, 0], zi[:-1]], dim=0)
        bj = torch.cat([state.prev_iq[None, :, 1], zq[:-1]], dim=0)
    dd = _tmaj_demod(cfg, zi, zq, br, bj)
    prev_iq = torch.stack([zi[m - 1], zq[m - 1]], dim=-1)      # (C, 2)
    davg, resamp, audio, nv = _tmaj_tail(cfg, state.deemph_avg, state.resamp,
                                         dd)
    return (ChannelizerStateTM(nco_num=nco_num, prev_iq=prev_iq,
                               deemph_avg=davg, resamp=resamp),
            audio, nv)


@functools.lru_cache(maxsize=16)
def _nco_rate(offsets: tuple, fs: int) -> np.ndarray:
    """(C,) float32 ``-2*pi32 * (off/fs)``, the per-sample angle step,
    in the reference's float32 operation order (the quotient on the host:
    IEEE on every device)."""
    offs = np.asarray(offsets, np.float32)
    return np.float32(-2.0 * np.float32(math.pi)) * (offs / np.float32(fs))


@functools.lru_cache(maxsize=64)
def _nco_block_advance(offsets: tuple, fs: int, n: int) -> np.ndarray:
    """(C,) float32 ``(2*pi32 * (off/fs) * n) mod 2pi``: the carried phase's
    advance over one block (float remainder = exact fmod + sign fix)."""
    offs = np.asarray(offsets, np.float32)
    a = (np.float32(2.0 * np.float32(math.pi)) * (offs / np.float32(fs))
         * np.float32(n))
    return np.remainder(a, np.float32(_TWO_PI)).astype(np.float32)


def _wrap_2pi(a: torch.Tensor) -> torch.Tensor:
    """``a mod 2pi`` as ``jnp.remainder`` computes it: an exact ``fmod``
    plus the sign fix (``torch.remainder`` on floats is ``a - b*floor(a/b)``,
    whose last bit can differ)."""
    r = torch.fmod(a, _TWO_PI)
    return torch.where(r < 0, r + _TWO_PI, r)


def channelize_step(cfg: ChannelizerConfig, state: ChannelizerState, block):
    """Channel-major mixer step: ``block`` (2N,) int16 at capture_rate ->
    ``(state, audio (C, cap), n_valid (C,))``."""
    fp32_products()
    dev = state.nco_phase.device
    x = rescale_cs16(as_block(block, dev))
    n = x.shape[0]
    offsets = tuple(cfg.offsets)
    fs = cfg.capture_rate

    # mix every channel: z * exp(-j(2*pi*off/fs * n + phase)).  The angle
    # w*n - phase is rounded once to float32, as the fused multiply-add of
    # the reference's compiled form gives (both products are exact in
    # float64); at up to ~pi*N rad one rounding step is ~1e-3 rad
    t = torch.arange(n, dtype=torch.float64, device=dev)[None, :]
    w = device_const(_nco_rate, offsets, fs, device=dev).to(torch.float64)
    theta = (w[:, None] * t
             - state.nco_phase.to(torch.float64)[:, None]).to(torch.float32)
    cs, sn = torch.cos(theta), torch.sin(theta)
    i, q = x[:, 0][None, :], x[:, 1][None, :]
    mi = i * cs - q * sn
    mq = i * sn + q * cs
    nco_phase = _wrap_2pi(
        state.nco_phase
        + device_const(_nco_block_advance, offsets, fs, n, device=dev))

    # per-channel boxcar decimate, planar
    m = n // cfg.downsample
    zi = mi.reshape(cfg.n_channels, m, cfg.downsample).sum(dim=2)
    zq = mq.reshape(cfg.n_channels, m, cfg.downsample).sum(dim=2)

    prev, davg, racc, rphase, audio, n_valid = demod_tail_batch_planar(
        cfg, state.prev_iq, state.deemph_avg, state.resamp.acc,
        state.resamp.phase, zi, zq)
    return (ChannelizerState(nco_phase=nco_phase, prev_iq=prev,
                             deemph_avg=davg,
                             resamp=ResampleState(racc, rphase),
                             sample_index=state.sample_index + 1),
            audio, n_valid)


def channelize_scan_blocks_tmaj(cfg: ChannelizerConfig,
                                state: ChannelizerStateTM, blocks):
    """``B`` chained :func:`channelize_step_tmaj` calls: ``blocks`` (B, 2N)
    -> ``(state, audio (B, cap, C), n_valid (B,))``, the per-block steps
    themselves (so the bytes equal per-block dispatch's)."""
    blocks = as_block(blocks, state.nco_num.device)
    audio, nv = [], []
    for i in range(blocks.shape[0]):
        state, a, v = channelize_step_tmaj(cfg, state, blocks[i])
        audio.append(a)
        nv.append(v)
    return state, torch.stack(audio), torch.stack(nv)
