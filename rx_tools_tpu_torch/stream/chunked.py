"""Chunked streaming: one device round trip per ``chunk`` blocks.

Counterpart of :mod:`rx_tools_tpu.stream.chunked`.  The runner reads ``chunk`` blocks from the source, moves
them to the device in one copy, runs them through the chain engine, and
drains audio + valid counts + levels to the host once per chunk — so
per-call overheads amortize 1/chunk while squelch and level metering
still observe every block.  Latency cost: ``chunk`` blocks of buffering;
the reference's analogous knob is the ``lcm_post``-scaled buffer length
(``rtl_fm.c:1387``).

Engines: ``engine="scan"`` (per-block semantics, ``stream/scan.py``,
the default) or ``engine="flat"`` (``models/fmchunk.py``, chunk-wide;
full chunks only, partial tail chunks take the scan engine).  The default
comes from ``RX_ENGINE``; ``fused`` (default ``RX_FUSED``) selects the
one-kernel front.

Checkpoints (``checkpoint_path``, every ``checkpoint_every`` blocks, 0 =
every drained chunk) hold the state of the chunk drained last, one chunk
behind the card, with the counters a resume needs
(``stream/pipeline.py::CheckpointMixin``; the format loads in both
packages).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.iq.sources import Source
from rx_tools_tpu_torch.models import fmchain, fmchunk
from rx_tools_tpu_torch.stream.pipeline import CheckpointMixin, RunnerStats
from rx_tools_tpu_torch.stream.scan import scan_fm_blocks


class ChunkedFmRunner(CheckpointMixin):
    """Drive the FM chain over a source in chunks of ``chunk`` blocks."""

    def __init__(self, cfg: fmchain.FmConfig, source: Source,
                 sink: Callable[[np.ndarray, float], None],
                 chunk: int = 8, block_size: int | None = None,
                 on_squelch: Callable[[], bool] | None = None,
                 exit_on_squelch: bool = False,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, *, engine: str | None = None,
                 fused: bool | None = None, device=None):
        self.cfg = cfg
        self.source = source
        self.sink = sink
        self.chunk = int(chunk)
        self.block_size = int(block_size or fmchain.block_samples(cfg))
        self.on_squelch = on_squelch
        self.exit_on_squelch = exit_on_squelch
        self.squelch_level = float(cfg.squelch_level)
        self.conseq_squelch = cfg.conseq_squelch
        self._hits = cfg.conseq_squelch + 1   # start muted (rtl_fm.c:1089-1091)
        self.device = resolve_device(device)
        self.state = fmchain.init_state(cfg, self.device)
        self.stats = RunnerStats()
        self._stop = False
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self._last_ckpt_blocks = 0
        self.fused = fused
        if engine is None:
            engine = "flat" if os.environ.get("RX_ENGINE", "") == "flat" \
                else "scan"
        if engine not in ("scan", "flat"):
            raise ValueError(f"unknown engine {engine!r}")
        # flat engine: one chunk-wide program (no per-block squelch gating,
        # so only squelch-off configs; -L level prints tick once per chunk)
        self._flat = (engine == "flat" and fmchunk.supports(cfg)
                      and cfg.squelch_level == 0)

    def stop(self) -> None:
        self._stop = True

    def _step(self, blocks: np.ndarray):
        """Run one chunk; returns (state, flat?, audio, n_valid, levels)."""
        dev_blocks = torch.from_numpy(blocks).to(self.device,
                                                 non_blocking=True)
        if self._flat and blocks.shape[0] == self.chunk:
            st, audio, n_valid, levels = fmchunk.fm_chunk_step(
                self.cfg, self.state, dev_blocks, fused=self.fused)
            return st, True, audio, n_valid, levels
        st, audio, n_valid, levels = scan_fm_blocks(
            self.cfg, self.state, dev_blocks, fused=self.fused)
        return st, False, audio, n_valid, levels

    def warmup(self) -> None:
        """Run one chunk of zeros (state discarded): builds the kernels at
        first use and exercises one device-to-host round trip."""
        blocks = np.zeros((self.chunk, 2 * self.block_size), np.int16)
        levels = self._step(blocks)[-1]
        levels.cpu()

    def run(self, max_blocks: int | None = None) -> RunnerStats:
        t0 = time.perf_counter()
        pending = None          # (outputs, checkpoint snapshot)
        while not self._stop:
            blocks, n_read = self._read_chunk(max_blocks)
            if blocks is None:
                break
            self.state, *out = self._step(blocks)
            self.stats.blocks += blocks.shape[0]
            self.stats.samples_in += n_read
            snap = (self.state, self.stats.blocks, self.stats.samples_in)
            if pending is not None:
                self._drain(*pending[0])
                self._maybe_checkpoint(*pending[1])
            pending = (out, snap)
            if max_blocks is not None and self.stats.blocks >= max_blocks:
                break
        if pending is not None:
            self._drain(*pending[0])
            self._maybe_checkpoint(*pending[1])
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    # ------------------------------------------------------------------
    def _read_chunk(self, max_blocks):
        want = self.chunk
        if max_blocks is not None:
            want = min(want, max_blocks - self.stats.blocks)
        if want <= 0:
            return None, 0
        out = np.zeros((want, 2 * self.block_size), np.int16)
        total = 0
        k = 0
        while k < want:
            n, buf = self.source.read_stream(self.block_size)
            if n < 0:
                sys.stderr.write("O")
                sys.stderr.flush()
                self.stats.overflows += 1
                continue
            if n == 0:
                break
            if n < self.block_size:
                # partial tail read (EOF): drop it rather than zero-pad —
                # padding would demodulate the pad into garbage audio
                break
            out[k, : 2 * n] = buf[: 2 * n]
            total += n
            k += 1
        if k == 0:
            return None, 0
        return out[:k], total

    def _drain(self, flat, audio, n_valid, levels):
        audio = audio.cpu().numpy()
        n_valid = n_valid.cpu().numpy()
        levels = levels.cpu().numpy()
        if flat:
            a = audio[: int(n_valid)]
            self.stats.samples_out += a.shape[0]
            self.sink(a, float(levels[-1]))
            return
        for i in range(audio.shape[0]):
            a = audio[i, : int(n_valid[i])]
            lvl = float(levels[i])
            if self.squelch_level > 0:
                if lvl < self.squelch_level:
                    self._hits += 1
                else:
                    self._hits = 0
                if self._hits > self.conseq_squelch:
                    if self.exit_on_squelch:
                        # -t negative: terminate_on_squelch (rtl_fm.c:925-927)
                        self.stop()
                        return
                    if self.cfg.squelch_zero:
                        # -E zero: emit the (already zeroed) audio
                        # (rtl_fm.c:929-937)
                        self.stats.samples_out += a.shape[0]
                        self.sink(a, lvl)
                        continue
                    if self.on_squelch is not None:
                        # scanning: hop and skip the rest of the chunk
                        # (rtl_fm.c:928-932)
                        if self.on_squelch():
                            self.stats.squelch_hops += 1
                        return
                    # single freq, no -E zero: skip output while squelched
                    continue
            self.stats.samples_out += a.shape[0]
            self.sink(a, lvl)
