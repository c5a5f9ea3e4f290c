"""The per-block streaming runtime (``rx_fm -b 1``): source -> device -> sink.

Counterpart of :mod:`rx_tools_tpu.stream.pipeline`.  The reference's
4-thread pipeline (``src/rtl_fm.c:866-958,1468-1472``) overlaps capture,
demodulation and output; here the overlap comes from CUDA's asynchronous
launches: the host queues block ``k``'s chain on the card, reads block
``k+1`` from the source while the card computes, and only then drains
block ``k-1``'s output (the device-to-host copy waits for the card), so
host I/O for one block hides under device compute of the next.

Failure semantics mirror the reference: a source overflow (negative
count) prints ``"O"`` to stderr and continues (``src/rtl_sdr.c:333-337``);
EOF (count 0) ends the run; squelch-driven hopping is a host decision
between blocks (``rtl_fm.c:928-932``).  Checkpoints are the chunked
runner's (``stream/checkpoint.py``), one per block by default.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from rx_tools_tpu_torch.iq.sources import Source


@dataclass
class RunnerStats:
    blocks: int = 0
    samples_in: int = 0
    samples_out: int = 0
    overflows: int = 0
    squelch_hops: int = 0
    wall_s: float = 0.0

    def realtime_multiple(self, rate: float) -> float:
        if self.wall_s <= 0:
            return float("inf")
        return (self.samples_in / rate) / self.wall_s


class CheckpointMixin:
    """Periodic snapshots and restore, shared by both runners: every
    ``checkpoint_every`` blocks the state drained last is saved with the
    counters that make it coherent (samples consumed, samples emitted,
    squelch hits, block size)."""

    checkpoint_path: str | None = None
    checkpoint_every: int = 0

    def restore(self, path: str) -> dict:
        """Load a checkpoint (either package, either runner); restores the
        carried state and the squelch counter and returns the meta dict, so
        the caller can reposition the source (``meta["samples_in"]``) and
        the output (``meta["samples_out"]``)."""
        from rx_tools_tpu_torch.stream.checkpoint import load_checkpoint
        state, meta = load_checkpoint(path, self.state)
        self.state = state
        self._hits = int(meta.get("hits", self._hits))
        self._last_ckpt_blocks = 0
        # the counters continue, so a later checkpoint (or a second
        # resume) stays coherent with the stream position
        self.stats.blocks = int(meta.get("blocks", 0))
        self.stats.samples_in = int(meta.get("samples_in", 0))
        self.stats.samples_out = int(meta.get("samples_out", 0))
        return meta

    def _maybe_checkpoint(self, state, blocks: int, samples_in: int) -> None:
        """Called after a drain: ``state`` is the carried state when
        exactly ``samples_in`` source samples were consumed and
        ``stats.samples_out`` samples emitted."""
        if self.checkpoint_path is None:
            return
        if blocks - self._last_ckpt_blocks < self.checkpoint_every:
            return
        from rx_tools_tpu_torch.stream.checkpoint import save_checkpoint
        save_checkpoint(self.checkpoint_path, state,
                        meta={"blocks": blocks, "samples_in": samples_in,
                              "samples_out": self.stats.samples_out,
                              "hits": self._hits,
                              "block_size": self.block_size})
        self._last_ckpt_blocks = blocks


class StreamRunner(CheckpointMixin):
    """Drive a ``(state, block) -> (state, out, n_valid, level)`` step over
    a block source, one block at a time.

    ``step``: the chain step with its config bound; ``state``: the initial
    carried state (on the device the step runs on); ``sink(out, level)``
    gets each block's valid prefix on the host; ``on_squelch`` is the
    scanning hook (return True when it retuned).
    """

    def __init__(self, step: Callable, state, source: Source, block_size: int,
                 sink: Callable[[np.ndarray, float], None],
                 on_squelch: Callable[[], bool] | None = None,
                 conseq_squelch: int = 10,
                 exit_on_squelch: bool = False,
                 squelch_zero: bool = False,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0):
        self.step = step
        self.state = state
        self.source = source
        self.block_size = int(block_size)
        self.sink = sink
        self.on_squelch = on_squelch
        self.conseq_squelch = conseq_squelch
        self.squelch_level = 0.0       # set by the app when -l is given
        self.exit_on_squelch = exit_on_squelch   # -t negative
        self.squelch_zero = squelch_zero         # -E zero
        self._hits = conseq_squelch + 1  # start muted (rtl_fm.c:1089-1091)
        self.stats = RunnerStats()
        self._stop = False
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every) or 1
        self._last_ckpt_blocks = 0

    def stop(self) -> None:
        """Signal-handler safe stop request (the ``do_exit`` analog)."""
        self._stop = True

    def warmup(self) -> None:
        """One block of zeros (state discarded): builds the kernels at
        first use and exercises one device-to-host round trip."""
        buf = np.zeros(2 * self.block_size, np.int16)
        self.step(self.state, buf)[-1].cpu()

    def run(self, max_blocks: int | None = None) -> RunnerStats:
        t0 = time.perf_counter()
        pending = None          # ((out, n_valid, level), checkpoint snapshot)
        n_read, buf = self._read_block()
        while not self._stop:
            if n_read < 0:
                # soft error: tolerate, mark, continue (rtl_sdr.c:333-337)
                sys.stderr.write("O")
                sys.stderr.flush()
                self.stats.overflows += 1
                n_read, buf = self._read_block()
                continue
            if n_read == 0:
                break
            # queue this block's chain on the card (asynchronous)
            self.state, out, n_valid, level = self.step(self.state, buf)
            self.stats.blocks += 1
            self.stats.samples_in += n_read
            snap = (self.state, self.stats.blocks, self.stats.samples_in)
            done = max_blocks is not None and self.stats.blocks >= max_blocks
            # read the NEXT block while the card computes — only if it will
            # be processed (a prefetched block must never be dropped, or a
            # resume would skip signal)
            next_read = None if done else self._read_block()
            # then drain the previous block's result
            if pending is not None:
                self._drain(*pending[0])
                self._maybe_checkpoint(*pending[1])
            pending = ((out, n_valid, level), snap)
            if done:
                break
            n_read, buf = next_read
        if pending is not None:
            self._drain(*pending[0])
            self._maybe_checkpoint(*pending[1])
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    # ------------------------------------------------------------------
    def _read_block(self):
        n, buf = self.source.read_stream(self.block_size)
        if 0 < n < self.block_size:
            # short tail read: zero-pad to the fixed block shape
            pad = np.zeros(2 * self.block_size, np.int16)
            pad[: 2 * n] = buf[: 2 * n]
            buf = pad
        return n, buf

    def _drain(self, out: torch.Tensor, n_valid: torch.Tensor,
               level: torch.Tensor) -> None:
        out_np = out.cpu().numpy()[: int(n_valid)]
        lvl = float(level)
        # host-side hop control (rtl_fm.c:923-937); dispositions match
        # ChunkedFmRunner._drain
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
                if self.squelch_zero:
                    # -E zero: emit the (already zeroed) audio
                    self.stats.samples_out += out_np.shape[0]
                    self.sink(out_np, lvl)
                    return
                if self.on_squelch is not None:
                    # scanning: hop and skip output; hits stay high so the
                    # next quiet block hops again (rtl_fm.c:928-932)
                    if self.on_squelch():
                        self.stats.squelch_hops += 1
                    return
                return  # single freq: skip output while squelched
        self.stats.samples_out += out_np.shape[0]
        self.sink(out_np, lvl)
