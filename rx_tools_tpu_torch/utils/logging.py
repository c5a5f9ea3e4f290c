"""The two-channel I/O contract: stdout = data plane, stderr = log plane.

The reference enforces this discipline rigorously — every status message goes
to stderr and device-init chatter is kept off the sample stream by dup2-ing
stdout onto stderr during bring-up (``src/convenience/convenience.c:447-466``,
engaged at ``src/rtl_fm.c:1389``/``880`` and ``src/rtl_sdr.c:237/317``).  We
keep the same contract for the CLIs.
"""

from __future__ import annotations

import os
import sys
import time


def log(msg: str, *args) -> None:
    """Status line on the log plane (stderr)."""
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def suppress_stdout_start() -> int:
    """Redirect fd 1 -> fd 2 so library chatter can't corrupt the data plane.

    Returns the saved stdout fd, to be passed to :func:`suppress_stdout_stop`.
    Mirrors ``suppress_stdout_start`` (convenience.c:447-457).
    """
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    return saved


def suppress_stdout_stop(saved: int) -> None:
    """Restore the real stdout (convenience.c:459-466)."""
    sys.stdout.flush()
    os.dup2(saved, 1)
    os.close(saved)


class ThroughputMeter:
    """Samples/s + realtime-multiple meter around the block loop.

    The reference has no perf counters at all (SURVEY.md §5: tracing is a
    couple of stderr prints); this is the observability layer the rebuild
    adds.  ``report_every`` seconds between stderr reports; ``rate`` is the
    nominal input sample rate so the realtime multiple can be shown.
    """

    def __init__(self, rate: float, report_every: float = 5.0, name: str = "stream"):
        self.rate = float(rate)
        self.report_every = float(report_every)
        self.name = name
        self.t0 = self.t_last = time.monotonic()
        self.samples = 0
        self.samples_last = 0

    def update(self, n_samples: int) -> None:
        self.samples += int(n_samples)
        now = time.monotonic()
        if now - self.t_last >= self.report_every:
            dt = now - self.t_last
            sps = (self.samples - self.samples_last) / dt
            mult = sps / self.rate if self.rate else float("inf")
            log("[%s] %.3f MS/s (%.1fx realtime), %d samples total",
                self.name, sps / 1e6, mult, self.samples)
            self.t_last = now
            self.samples_last = self.samples

    def summary(self) -> dict:
        dt = time.monotonic() - self.t0
        sps = self.samples / dt if dt > 0 else 0.0
        return {"samples": self.samples, "seconds": dt, "samples_per_s": sps,
                "realtime_multiple": sps / self.rate if self.rate else None}
