"""Run statistics of the block-streaming runtime.

Counterpart of :mod:`rx_tools_tpu.stream.pipeline`; the per-block
``StreamRunner`` (``rx_fm -b 1``) is not yet ported — the chunked runner
(:mod:`.chunked`) drives the chain.
"""

from __future__ import annotations

from dataclasses import dataclass


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
