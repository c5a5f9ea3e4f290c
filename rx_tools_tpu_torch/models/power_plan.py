"""The sweep planner: rx_power's ``frequency_range`` re-implemented exactly.

A pure-Python copy of :mod:`rx_tools_tpu.models.power_plan`, tested equal
to it field for field.

Reference algorithm (``src/rtl_power.c:431-543``): split ``lo:hi:max_bin``
into the fewest evenly-sized hops whose (crop-inflated) bandwidth fits under
MAXIMUM_RATE; if the whole span is under MINIMUM_RATE, use one oversampled
hop with decimation; pick the power-of-two bin count (bin_e <= 21) whose bin
size is under the requested maximum; giant bins (>= 1 MHz) switch to the
total-power path (bin_e = 0, crop = 0).  All integer-truncation behaviours
are kept so hop frequencies, rates and bin sizes match the reference's CSV
headers exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

MAXIMUM_RATE = 2_800_000
MINIMUM_RATE = 1_000_000
DEFAULT_BUF_LENGTH = 16384
MAX_TUNES = 10000


@dataclass
class TuningState:
    """One hop (``struct tuning_state``, rtl_power.c:89-108)."""
    freq: int
    rate: int
    bin_e: int
    downsample: int
    downsample_passes: int
    crop: float
    buf_len: int

    @property
    def bin_len(self) -> int:
        return 1 << self.bin_e


def plan_sweep(lower: float, upper: float, max_size: float, crop: float = 0.0,
               boxcar: bool = True) -> list[TuningState]:
    """``frequency_range`` (rtl_power.c:431-543) minus the I/O."""
    lower, upper, max_size = int(lower), int(upper), int(max_size)
    if upper <= lower:
        raise ValueError(f"empty frequency range: {lower}:{upper}")
    if max_size < 1:
        raise ValueError(f"bin size must be >= 1 Hz, got {max_size}")
    downsample = 1
    downsample_passes = 0
    tune_count = 0
    bw_seen = bw_used = 0
    for i in range(1, 1500):
        bw_seen = (upper - lower) // i
        bw_used = int(bw_seen / (1.0 - crop))
        if bw_used > MAXIMUM_RATE:
            continue
        tune_count = i
        break
    if bw_used < MINIMUM_RATE:
        tune_count = 1
        downsample = MAXIMUM_RATE // bw_used
        if downsample <= 0:
            raise ValueError("unsupported bandwidth")
        bw_used = bw_used * downsample
    if not boxcar and downsample > 1:
        downsample_passes = int(math.log2(downsample))
        downsample = 1 << downsample_passes
        bw_used = int((bw_seen * downsample) / (1.0 - crop))
    bin_e = 0
    for i in range(1, 22):
        bin_e = i
        bin_size = bw_used / float((1 << i) * downsample)
        if bin_size <= max_size:
            break
    if max_size >= MINIMUM_RATE:
        bw_seen = max_size
        bw_used = max_size
        tune_count = (upper - lower) // bw_seen
        bin_e = 0
        crop = 0.0
    if tune_count > MAX_TUNES:
        raise ValueError("Error: bandwidth too wide.")
    if tune_count < 1:
        raise ValueError("no hops planned (empty range?)")
    buf_len = 2 * (1 << bin_e) * downsample
    if buf_len < DEFAULT_BUF_LENGTH:
        buf_len = DEFAULT_BUF_LENGTH
    return [
        TuningState(
            freq=lower + i * bw_seen + bw_seen // 2,
            rate=bw_used,
            bin_e=bin_e,
            downsample=downsample,
            downsample_passes=downsample_passes,
            crop=crop,
            buf_len=buf_len,
        )
        for i in range(tune_count)
    ]


def describe_plan(tunes: list[TuningState]) -> list[str]:
    """The stderr report lines (rtl_power.c:533-542)."""
    t = tunes[0]
    total_bins = len(tunes) * t.bin_len
    logged = int(total_bins * (1.0 - t.crop))
    bin_size = t.rate / float(t.bin_len * t.downsample)
    return [
        f"Number of frequency hops: {len(tunes)}",
        f"Dongle bandwidth: {t.rate}Hz",
        f"Downsampling by: {t.downsample}x",
        f"Cropping by: {t.crop * 100:0.2f}%",
        f"Total FFT bins: {total_bins}",
        f"Logged FFT bins: {logged}",
        f"FFT bin size: {bin_size:0.2f}Hz",
        f"Buffer size: {t.buf_len} bytes ({1000 * 0.5 * t.buf_len / t.rate:0.2f}ms)",
    ]
