"""Shared CLI plumbing: the ``convenience`` library re-imagined.

Counterpart of :mod:`rx_tools_tpu.apps.common`.  Device selection is
``rx_tools_tpu_torch.device`` (the JAX package's ``select_platform`` has no
counterpart); ``RX_PROFILE`` takes a ``torch.profiler`` trace in place of
a ``jax.profiler`` one.  Replicates the
reference's L1 layer (``src/convenience/convenience.c``):
``verbose_*`` wrappers that log every device mutation to stderr, the gain
string / kwargs parsers, and the stdout-suppression contract (stdout is the
data plane, stderr the log plane — ``convenience.c:447-466``).
"""

from __future__ import annotations

import os
import signal
import sys

from rx_tools_tpu_torch.iq.sources import Source, make_source, show_device_info
from rx_tools_tpu_torch.utils.logging import log


class suppress_stdout:
    """Context manager over the dup2 stdout->stderr trick
    (convenience.c:447-466): device-init chatter cannot corrupt the data
    plane while inside the block."""

    def __enter__(self):
        from rx_tools_tpu_torch.utils.logging import suppress_stdout_start
        self._saved = suppress_stdout_start()
        return self

    def __exit__(self, *exc):
        from rx_tools_tpu_torch.utils.logging import suppress_stdout_stop
        suppress_stdout_stop(self._saved)
        return False


class maybe_profile:
    """``RX_PROFILE=<dir>`` wraps the run in a ``torch.profiler`` trace of
    the host and, where CUDA is available, the card; the Chrome trace is
    written into the directory as ``rx_trace.<pid>.json``.  Unset, it does
    nothing."""

    def __init__(self):
        self.dir = os.environ.get("RX_PROFILE")
        self._prof = None

    def __enter__(self):
        if self.dir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            log("Profiling to %s", self.dir)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(
                os.path.join(self.dir, f"rx_trace.{os.getpid()}.json"))
            self._prof = None
        return False


def verbose_device_search(query: str, wire_format: str = "CS16") -> Source:
    """``verbose_device_search`` (convenience.c:469-489).

    Source-construction failures (missing file, bad kwargs) exit with a
    clean message like the reference's "Failed to open..." path, not a
    traceback.  ``wire_format`` is forwarded to hardware sources
    (rx_sdr's ``-I``; rtl_sdr.c:301 passes it to setupStream).
    """
    log("Acquired device with query: '%s'", query)
    try:
        src = make_source(query, wire_format=wire_format)
    except (OSError, ValueError, RuntimeError) as e:
        log("Failed to open source with query '%s': %s", query, e)
        raise SystemExit(1)
    show_device_info(src)
    return src


def verbose_set_frequency(src: Source, freq: float) -> int:
    r = src.set_frequency(freq)
    if r != 0:
        log("WARNING: Failed to set center freq.")
    else:
        log("Tuned to %d Hz.", int(freq))
    return r


def verbose_set_sample_rate(src: Source, rate: float) -> int:
    r = src.set_sample_rate(rate)
    if r != 0:
        log("WARNING: Failed to set sample rate.")
    else:
        log("Sampling at %u S/s.", int(rate))
    return r


def verbose_set_bandwidth(src: Source, bw: float) -> int:
    r = src.set_bandwidth(bw)
    if r != 0:
        log("WARNING: Failed to set bandwidth.")
    elif bw > 0:
        log("Bandwidth parameter %u Hz resulted in %u Hz.", int(bw),
            int(src.bandwidth))
    else:
        log("Bandwidth set to automatic resulted in %u Hz.", int(src.bandwidth))
    return r


def verbose_gain_str_set(src: Source, gain_str: str | None) -> int:
    """Scalar or ``NAME=val,...`` per-element gains (convenience.c:287-327);
    ``None`` = auto gain with per-driver defaults (convenience.c:238-285)."""
    if gain_str is None:
        # per-driver auto-gain defaults (verbose_auto_gain,
        # convenience.c:238-285): sources that know their hardware apply
        # the reference's quirks (e.g. rtl_tcp = RTLSDR -> 40 dB "semi-
        # automatic"); others keep driver defaults
        if hasattr(src, "set_auto_gain"):
            return src.set_auto_gain()
        log("Using automatic gain control.")
        return 0
    if "=" in gain_str:
        r = 0
        for pair in gain_str.split(","):
            name, _, value = pair.partition("=")
            r |= src.set_gain_element(name.strip(), float(value))
            log("Setting gain element %s: %.1f dB.", name.strip(), float(value))
        return r
    value = float(gain_str)
    r = src.set_gain(value)
    if r != 0:
        log("WARNING: Failed to set tuner gain.")
    else:
        log("Tuner gain set to %0.2f dB.", value)
    return r


def verbose_antenna_str_set(src: Source, antenna: str) -> int:
    r = src.set_antenna(antenna)
    if r != 0:
        log("WARNING: Failed to set antenna.")
    else:
        log("Antenna set to '%s'.", antenna)
    return r


def verbose_ppm_set(src: Source, ppm: float) -> int:
    """Skip if 0, like the reference (convenience.c:337-349)."""
    if ppm == 0:
        return 0
    r = src.set_frequency_correction(ppm)
    if r != 0:
        log("WARNING: Failed to set ppm error.")
    else:
        log("Tuner error set to %i ppm.", int(ppm))
    return r


def verbose_direct_sampling(src: Source, mode: int) -> int:
    """writeSetting("direct_samp") + readback verify (convenience.c:183-212).

    The messages report what the hardware actually APPLIED (the read-back
    value), not what was requested — a driver that rejects the setting is
    surfaced as a WARNING instead of silently mis-sampling.
    """
    r = src.write_setting("direct_samp", str(mode))
    applied = src.read_setting("direct_samp")
    if applied is None:
        log("WARNING: Failed to set direct sampling mode.")
        return r
    try:
        applied_i = int(applied)
    except ValueError:
        applied_i = -1
    if applied_i == 0:
        log("Direct sampling mode disabled.")
    elif applied_i == 1:
        log("Enabled direct sampling mode, input 1/I.")
    elif applied_i == 2:
        log("Enabled direct sampling mode, input 2/Q.")
    if mode == 3:
        log("Enabled no-mod direct sampling mode.")
    return r


def verbose_offset_tuning(src: Source) -> int:
    """writeSetting("offset_tune") + readback verify
    (convenience.c:214-236)."""
    r = src.write_setting("offset_tune", "true")
    applied = src.read_setting("offset_tune")
    if applied is None:
        log("WARNING: Failed to set offset tuning.")
    elif applied != "true":
        log("WARNING: Failed to set offset tuning.")
    else:
        log("Offset tuning mode enabled.")
    return r


def verbose_settings(src: Source, kwargs_str: str) -> int:
    """``-t key=val,...`` writeSetting loop (convenience.c:363-380)."""
    r = 0
    if not kwargs_str:
        return 0
    for pair in kwargs_str.split(","):
        key, _, value = pair.partition("=")
        r |= src.write_setting(key.strip(), value)
        log("Setting %s: %s", key.strip(), value)
    return r


def open_output(filename: str | None):
    """Positional filename, ``-``/absent = stdout (binary)."""
    if filename is None or filename == "-":
        return sys.stdout.buffer
    return open(filename, "wb")


def install_sigint(handler) -> None:
    """POSIX signal handling (the reference's sighandler analog)."""
    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
