"""The spectral "model": rx_power's per-hop FFT integration on tensors.

Counterpart of :mod:`rx_tools_tpu.models.powerscan`.  The reference's
``scanner`` (``src/rtl_power.c:670-772``) walks the hop table, and within
each hop the FFT segments, one at a time.  Here:

- within a hop, all segments batch into one ``(n_segments, bin_len)`` FFT;
- across hops, :func:`sweep_step` runs the hop body once over a leading
  ``(H, ...)`` axis (the reference package's ``jax.vmap``), so a sweep is
  one host-to-device copy and one batched device step.

Accumulators are float32 in reference units (see ``ops.spectrum``) and stay
on the device between CSV flushes; the CSV layer applies csv_dbm's quirks
at output time (:func:`csv_row_values`).  The ``--int-fft`` tier
(:func:`int_sweep_powers`) returns bit-exact per-segment powers for the
caller's exact int64 accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.ops import intfft
from rx_tools_tpu_torch.ops import spectrum as sp
from rx_tools_tpu_torch.ops.numeric import device_const


@dataclass(frozen=True)
class PowerConfig:
    bin_e: int                    # log2 bins (0 => total-power path)
    downsample: int = 1
    downsample_passes: int = 0    # -F path (recursive fifth-order)
    boxcar: bool = True
    comp_fir_size: int = 0
    window: str = "rectangle"
    peak_hold: bool = False
    buf_len: int = 16384          # interleaved elements per hop read

    @property
    def bin_len(self) -> int:
        return 1 << self.bin_e


class SweepAccum(NamedTuple):
    avg: torch.Tensor             # (H, bin_len) power accumulators
    samples: torch.Tensor         # (H,) int32


def new_sweep_accum(n_hops: int, cfg: PowerConfig,
                    device=None) -> SweepAccum:
    """Zeroed accumulators on ``device`` (CUDA unless the CPU is asked
    for; ``device.resolve_device``)."""
    dev = resolve_device(device)
    return SweepAccum(
        torch.zeros((n_hops, cfg.bin_len), dtype=torch.float32, device=dev),
        torch.zeros((n_hops,), dtype=torch.int32, device=dev))


def _decimate(cfg: PowerConfig, x: torch.Tensor) -> torch.Tensor:
    """Hop-local decimation (rtl_power.c:721-743) of ``x`` (H, N, 2)."""
    if cfg.boxcar and cfg.downsample > 1:
        h, n = x.shape[0], x.shape[1] // cfg.downsample
        x = x[:, : n * cfg.downsample].reshape(h, n, cfg.downsample, 2) \
            .sum(dim=2)
    elif cfg.downsample_passes:
        # fresh zero history on every hop, as the reference package does
        # (its variant is stateless per block, "ease in", rtl_power.c:
        # 594-597).  The ops filter along dim 0, so the hops ride along as
        # a middle axis: (N, H, 2) with (passes, 5, H, 2) of history.
        passes = cfg.downsample_passes
        t = x.transpose(0, 1)
        hist = torch.zeros((passes, 5) + t.shape[1:], dtype=x.dtype,
                           device=x.device)
        _, t = ops.fifth_order_cascade(ops.FifthOrderState(hist), t, passes)
        if cfg.comp_fir_size == 9:
            droop = torch.zeros((9,) + t.shape[1:], dtype=x.dtype,
                                device=x.device)
            _, t = ops.droop_fir(ops.DroopState(droop), t, passes)
        x = t.transpose(0, 1)
    return x


def _hop_body(cfg: PowerConfig, win, avg, samples, blocks):
    """``blocks`` (H, buf_len) int16 -> updated ``avg`` (H, bin_len) and
    ``samples`` (H,)."""
    h = blocks.shape[0]
    x = blocks.to(torch.float32).reshape(h, -1, 2) * (1.0 / 256.0)
    x = _decimate(cfg, x)
    if cfg.bin_e == 0:
        p = sp.total_power(x)[:, None]
        avg = torch.maximum(avg, p) if cfg.peak_hold else avg + p
        return avg, samples + 1
    x = sp.remove_dc(x)
    segs = x.shape[1] // cfg.bin_len
    x = x[:, : segs * cfg.bin_len].reshape(h, segs, cfg.bin_len, 2)
    return sp.segmented_power_spectrum(x, win, avg, samples, cfg.downsample,
                                       cfg.peak_hold)


def _window(cfg: PowerConfig, device) -> torch.Tensor:
    return device_const(ops.window, cfg.window, max(cfg.bin_len, 1),
                        device=device)


def _on(blocks, device: torch.device) -> torch.Tensor:
    """Host blocks (numpy or tensor) on ``device``: one copy."""
    return torch.as_tensor(blocks).to(device)


def power_hop_step(cfg: PowerConfig, avg, samples, block):
    """One hop, one read: ``block`` (buf_len,) int16 -> updated (avg,
    samples), on ``avg``'s device.

    Input is raw CS16 in the ±32767 range; scaled to the ±128 8-bit
    contract (see ops.spectrum) before windowing.
    """
    dev = avg.device
    a, s = _hop_body(cfg, _window(cfg, dev), avg[None], samples[None],
                     _on(block, dev)[None])
    return a[0], s[0]


def sweep_step(cfg: PowerConfig, acc: SweepAccum, blocks) -> SweepAccum:
    """All hops at once: ``blocks`` (H, buf_len) int16, on the host or on
    ``acc``'s device.  The reference's serial hop loop becomes the batch
    axis of one device step."""
    dev = acc.avg.device
    avg, samples = _hop_body(cfg, _window(cfg, dev), acc.avg, acc.samples,
                             _on(blocks, dev))
    return SweepAccum(avg, samples)


def int_sweep_powers(cfg: PowerConfig, blocks, device=None):
    """``--int-fft`` batched hop processing: ``blocks`` (H, buf_len) int16
    -> per-segment powers (H, segs, bin_len) int32, every stage bit-exact
    to the C scanner (ops/intfft.py; rtl_power.c:714-770).  The caller
    accumulates into int64 (exact; see intfft docstring).  Runs on the
    blocks' device for a tensor, else on ``device`` (resolved as usual).

    Only the boxcar decimation path is supported (the reference's default;
    ``-F 9`` keeps the float plane)."""
    if not cfg.boxcar and cfg.downsample_passes:
        raise ValueError("--int-fft supports the boxcar decimation path "
                         "only (drop -F)")
    if cfg.downsample > 1 and cfg.buf_len % (2 * cfg.downsample):
        raise ValueError("--int-fft: buf_len not divisible by 2*downsample "
                         "(partial-group boxcar tail unsupported)")
    eff = cfg.buf_len // cfg.downsample
    if eff * 32768 >= 2**31:
        raise ValueError("--int-fft: hop too long for exact int32 sums")
    dev = (blocks.device if isinstance(blocks, torch.Tensor)
           else resolve_device(device))
    win = device_const(ops.window_coefs_int, cfg.window, cfg.bin_len,
                       device=dev)
    return intfft.int_hop_segments(_on(blocks, dev), win, cfg.bin_e,
                                   cfg.downsample)


def csv_row_values(avg: np.ndarray, samples: int, cfg: PowerConfig,
                   freq: float, rate: float, crop: float):
    """Apply csv_dbm's output math (rtl_power.c:774-817) to one hop's
    accumulator (host numpy).  Returns (freq_low, freq_high, hz_step,
    samples, dbm list) including the trailing duplicate-bin quirk."""
    ln = cfg.bin_len
    a = np.asarray(avg, dtype=np.float64).copy()
    ds = cfg.downsample
    if cfg.bin_e > 0:
        a[0] = a[1]
        a = np.concatenate([a[ln // 2:], a[: ln // 2]])
    bin_count = int(ln * (1.0 - crop))
    bw2 = int((rate * bin_count) / (ln * 2 * ds))
    hz_step = rate / float(ln * ds)
    i1 = int(ln * crop * 0.5)
    i2 = (ln - 1) - int(ln * crop * 0.5)
    with np.errstate(divide="ignore"):
        dbms = list(10.0 * np.log10(a[i1: i2 + 1] / rate / max(samples, 1)))
        tail = a[i2] / (rate * max(samples, 1))
        if cfg.bin_e == 0:
            tail = a[0] / (rate * max(samples, 1))
        dbms.append(float(10.0 * np.log10(tail)) if tail > 0 else float("-inf"))
    return int(freq) - bw2, int(freq) + bw2, hz_step, samples, dbms
