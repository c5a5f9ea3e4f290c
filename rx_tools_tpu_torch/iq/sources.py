"""Block sources — the framework's "device" layer (host side, numpy).

The port of :mod:`rx_tools_tpu.iq.sources`: the same ``-d`` query-string
registry (``src/convenience/convenience.c:382-513``) and the same
``read_stream(n_elems)`` contract — fixed-size interleaved CS16 int16
blocks, negative counts for soft errors (``src/rtl_sdr.c:333-337``).

- ``-d file=<path>[,format=CS16][,rate=2.4M][,loop=1]`` — replay a capture.
- ``-d stdin[,format=CU8]``                             — pipe from stdin.
- ``-d synth=fm[,audio=1k][,dev=75k][,snr=...]``        — synthetic signals,
  sample for sample the reference package's generator.
- ``-d rtltcp=host[:port]``                             — remote hardware
  over the rtl_tcp network protocol (iq/rtltcp.py).
- ``-d driver=<name>[,...]``                            — a SoapySDR device
  through libSoapySDR (iq/soapy.py).
- ``""`` (empty, the reference default)                 — synthetic noise.

Every source is host code: it yields numpy blocks, and a runner copies
them to the device.  Files of every wire format are widened to CS16 by
:mod:`rx_tools_tpu_torch.iq.formats` (the native codecs when built), read
ahead by the native ``Feeder`` thread when the library is built.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass

import numpy as np

from rx_tools_tpu_torch.iq import formats
from rx_tools_tpu_torch.utils.logging import log
from rx_tools_tpu_torch.utils.units import atofs, parse_kwargs

#: readStream soft error codes (SoapySDR convention)
ERR_OVERFLOW = -4
ERR_TIMEOUT = -1


class Source:
    """Abstract block source ("device")."""

    #: nominal info for show_device_info analog
    driver = "abstract"
    hardware = "none"

    def __init__(self):
        self.sample_rate = 2_048_000.0
        self.frequency = 100e6
        self.frequency_correction = 0.0
        self.bandwidth = 0.0
        self.gains: dict[str, float] = {}
        self.antenna = "RX"
        self.settings: dict[str, str] = {}
        self.channel = 0

    # -- configuration (the verbose_* surface) ------------------------------
    def set_sample_rate(self, rate: float) -> int:
        self.sample_rate = float(rate)
        return 0

    def set_frequency(self, freq: float) -> int:
        self.frequency = float(freq)
        return 0

    def get_frequency(self) -> float:
        return self.frequency

    def set_bandwidth(self, bw: float) -> int:
        self.bandwidth = float(bw)
        return 0

    def set_gain(self, value: float) -> int:
        self.gains["TOTAL"] = float(value)
        return 0

    def set_gain_element(self, name: str, value: float) -> int:
        self.gains[name] = float(value)
        return 0

    def set_antenna(self, name: str) -> int:
        self.antenna = name
        return 0

    def set_frequency_correction(self, ppm: float) -> int:
        self.frequency_correction = float(ppm)
        return 0

    def set_gain_mode(self, automatic: bool) -> int:
        """``SoapySDRDevice_setGainMode`` analog: the reference calls it
        unconditionally with the ``-E rtlagc/agc`` flag (rtl_fm.c:1432).
        Framework sources record the request; hardware sources override
        with the real device call."""
        self.settings["gain_mode"] = "true" if automatic else "false"
        return 0

    def write_setting(self, key: str, value: str) -> int:
        self.settings[key] = value
        return 0

    def read_setting(self, key: str) -> str | None:
        return self.settings.get(key)

    # -- streaming -----------------------------------------------------------
    def activate(self) -> None:
        pass

    def deactivate(self) -> None:
        pass

    def close(self) -> None:
        pass

    def read_stream(self, n_elems: int) -> tuple[int, np.ndarray]:
        """Read up to ``n_elems`` complex samples.

        Returns ``(count, buf)`` where ``buf`` is interleaved int16 of length
        ``2*count`` (CS16).  ``count`` <= 0 signals EOF (0) or a soft error
        (negative, e.g. :data:`ERR_OVERFLOW`).
        """
        raise NotImplementedError

    # -- enumeration (show_device_info analog, convenience.c:382-445) --------
    def info(self) -> dict:
        return {
            "driver": self.driver,
            "hardware": self.hardware,
            "antennas": [self.antenna],
            "gains": sorted(self.gains) or ["TOTAL"],
            "frequency_range": (0.0, 6e9),
            "sample_rates": [250e3, 1.024e6, 2.048e6, 2.4e6, 2.8e6, 3.2e6],
        }


@dataclass
class _FileParams:
    path: str
    format: str = "CS16"
    rate: float = 2_048_000.0
    loop: bool = False
    format_pinned: bool = True     # False => probe for a WAV header
    rate_pinned: bool = True


class FileSource(Source):
    """Replay an I/Q capture file (any wire format) as a CS16 stream."""

    driver = "file"

    def __init__(self, params: _FileParams):
        super().__init__()
        self.p = params
        self.sample_rate = params.rate
        self.hardware = os.path.basename(params.path)
        self._f = open(params.path, "rb") if params.path != "-" else sys.stdin.buffer
        self._fmt = formats.parse_fmt(params.format)
        self._pending = b""
        self._data_start = 0        # loop mode rewinds here (past WAV header)
        if not params.format_pinned:
            self._probe_wav(params)
        # native readahead feeder (the dongle-thread analog): lossless
        # backpressure mode; skipped for stdin (fd lifetime) and loop mode
        # (feeder cannot seek)
        self._feeder = None
        if (params.path != "-" and not params.loop):
            from rx_tools_tpu_torch import native
            if native.available():
                elem = formats.ELEM_BYTES[self._fmt]
                block = max(elem * 16384, 65536)
                self._feeder = native.Feeder(self._f.fileno(),
                                             block - block % elem,
                                             depth=8, drop_on_full=False)

    def _probe_wav(self, params: _FileParams) -> None:
        """Auto-detect a RIFF/WAVE capture (rx_fm -E wav / rtl_fm
        generate_header output): take rate + format from the header and
        stream the data chunk.  Non-WAV bytes are replayed untouched."""
        from rx_tools_tpu_torch.iq import wavread
        info, consumed = wavread.parse_wav(self._f.read)
        if info is not None:
            self._fmt = info.iq_format
            if not params.rate_pinned:
                self.sample_rate = float(info.rate)
            log("Detected WAV capture: %d ch, %d-bit, %d S/s (-> %s)",
                info.channels, info.bits, info.rate, self._fmt)
        if self._f is sys.stdin.buffer:
            if info is None:
                self._pending = consumed   # replay the probed bytes
            return
        # Reopen at the data offset: BufferedReader.seek satisfies small
        # seeks inside its readahead buffer WITHOUT moving the raw fd, and
        # the native feeder reads the raw fd — a fresh reader's first seek
        # is a real lseek, so both the buffered and raw positions agree.
        pos = self._f.tell() if info is not None else 0
        self._f.close()
        self._f = open(params.path, "rb")
        self._f.seek(pos)
        self._data_start = pos

    def _read_bytes(self, need: int) -> bytes:
        buf = self._pending
        if self._feeder is not None:
            while len(buf) < need:
                blk = self._feeder.read_block()
                if blk is None:
                    break
                buf += blk.tobytes()
            return buf
        while len(buf) < need:
            chunk = self._f.read(need - len(buf))
            if not chunk:
                if self.p.loop and self._f is not sys.stdin.buffer:
                    self._f.seek(self._data_start)
                    continue
                break
            buf += chunk
        return buf

    def read_stream(self, n_elems: int) -> tuple[int, np.ndarray]:
        elem = formats.ELEM_BYTES[self._fmt]
        need = n_elems * elem
        buf = self._read_bytes(need)
        # trim to whole elements; keep at most one block of remainder
        n = min(len(buf) // elem, n_elems)
        self._pending = buf[n * elem:]
        if n == 0:
            return 0, np.empty(0, np.int16)
        raw = formats.bytes_to_array(buf[: n * elem], self._fmt)
        cs16 = formats.convert(raw, self._fmt, "CS16")
        return n, np.asarray(cs16, dtype=np.int16)

    def close(self) -> None:
        if self._feeder is not None:
            self._feeder.close()
            self._feeder = None
        if self._f is not sys.stdin.buffer:
            self._f.close()


class SynthSource(Source):
    """Synthetic signal generator ("driver=synth").

    Generates a configurable scene of emitters; retuning shifts which emitters
    fall in-band, so frequency-hop logic (rx_fm scanning, rx_power sweeps) is
    exercised exactly as against hardware.  Deterministic given ``seed``.

    kwargs (``|``-separated values describe multiple emitters; shorter
    lists broadcast their last value):
      ``synth=fm|am|usb|lsb|tone|noise|silence`` — modulation (shared)
      ``carrier=<f1>[|<f2>...]`` — emitter RF frequencies (default: tune freq)
      ``audio=<f1>[|...]``  — baseband tone frequency (default 1 kHz)
      ``dev=<f1>[|...]``    — FM deviation (default 75k wideband)
      ``amp=<a1>[|...]``    — emitter amplitude relative to full scale (0.5)
      ``noise=<0..1>``      — AWGN sigma relative to full scale (0.001)
      ``seed=<int>``
      ``det=1``             — deterministic-per-retune: every
                              ``set_frequency`` resets the sample counter,
                              NCO phases and noise RNG, so the stream after
                              a retune is a pure function of the tuned
                              frequency.  Makes hop reads independent of
                              which process (or past sweep) performed them
                              — the property the multi-process sweep
                              equality tests rely on.
    """

    driver = "synth"
    hardware = "synthetic scene"

    @staticmethod
    def _list(kwargs, key, default):
        raw = kwargs.get(key)
        if raw is None:
            return None if default is None else [default]
        return [atofs(v) for v in str(raw).split("|") if v]

    def __init__(self, kwargs: dict[str, str]):
        super().__init__()
        self.kind = kwargs.get("synth", "tone") or "tone"
        self.carriers = self._list(kwargs, "carrier", None)
        self.audios = self._list(kwargs, "audio", 1000.0)
        self.deviations = self._list(kwargs, "dev", 75e3)
        self.amps = [float(v) for v in str(kwargs.get("amp", "0.5")).split("|")]
        self.noise = float(kwargs.get("noise", "0.001"))
        self.seed = int(kwargs.get("seed", "0"))
        self.det = bool(int(kwargs.get("det", "0")))
        self._rng = np.random.default_rng(self.seed)
        self._phase = None      # (E,) carrier NCO phases (radians)
        self._mod_phase = None  # (E,) audio/modulation phases
        self._n = 0             # absolute sample counter

    def set_frequency(self, freq: float) -> int:
        super().set_frequency(freq)
        if self.carriers is None:
            self.carriers = [float(freq)]
        if self.det:
            # deterministic-per-retune: the post-retune stream depends only
            # on the tuned frequency, never on read history
            self._rng = np.random.default_rng(self.seed)
            self._phase = None
            self._mod_phase = None
            self._n = 0
        return 0

    @staticmethod
    def _bcast(vals, e):
        return np.array([vals[min(i, len(vals) - 1)] for i in range(e)],
                        np.float64)

    def _baseband(self, n: int, fs: float) -> np.ndarray:
        """Complex baseband: sum of emitters at offsets (carrier - tuned)."""
        t = (self._n + np.arange(n)) / fs
        carriers = np.array(self.carriers if self.carriers is not None
                            else [self.frequency], np.float64)
        e = carriers.shape[0]
        if self._phase is None or self._phase.shape[0] != e:
            self._phase = np.zeros(e)
            self._mod_phase = np.zeros(e)
        offsets = carriers - self.frequency                       # (E,)
        audios = self._bcast(self.audios, e)
        devs = self._bcast(self.deviations, e)
        amps = self._bcast(self.amps, e)
        audio = np.sin(2 * math.pi * audios[:, None] * t[None, :]
                       + self._mod_phase[:, None])                # (E, N)
        if self.kind in ("silence",):
            sig = np.zeros((e, n), np.complex128)
        elif self.kind == "noise":
            sig = (self._rng.standard_normal((e, n))
                   + 1j * self._rng.standard_normal((e, n))) * 0.5
        elif self.kind == "tone":
            sig = np.ones((e, n), np.complex128)
        elif self.kind == "fm":
            # integrate deviation * audio for the instantaneous phase
            dphi = 2 * math.pi * devs[:, None] * audio / fs
            sig = np.exp(1j * (self._phase[:, None] + np.cumsum(dphi, axis=1)))
            self._phase = (self._phase + dphi.sum(axis=1)) % (2 * math.pi)
        elif self.kind == "am":
            sig = (1.0 + 0.8 * audio).astype(np.complex128)
        elif self.kind in ("usb", "lsb"):
            sign = 1.0 if self.kind == "usb" else -1.0
            sig = np.exp(sign * 2j * math.pi * audios[:, None] * t[None, :])
        else:
            raise ValueError(f"unknown synth kind: {self.kind}")
        mix = np.exp(2j * math.pi * offsets[:, None] * t[None, :])
        # front-end selectivity: a real tuner's anti-alias filtering keeps
        # far-out-of-band emitters from folding in; roll off past Nyquist
        # so sweep hops see an emitter only when it is actually in-band
        rel = np.abs(offsets) / (fs / 2.0)
        atten = np.where(rel <= 1.0, 1.0,
                         10.0 ** (-4 * np.minimum(rel - 1.0, 1.0)))
        out = np.sum((amps * atten)[:, None] * sig * mix, axis=0)
        if self.noise:
            out = out + self.noise * (
                self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n))
        self._mod_phase = self._mod_phase % (2 * math.pi)
        return out

    def read_stream(self, n_elems: int) -> tuple[int, np.ndarray]:
        fs = self.sample_rate
        z = self._baseband(n_elems, fs)
        self._n += n_elems
        iq = np.empty(2 * n_elems, np.int16)
        scaled = np.clip(np.round(np.real(z) * 32767), -32768, 32767)
        iq[0::2] = scaled.astype(np.int16)
        scaled = np.clip(np.round(np.imag(z) * 32767), -32768, 32767)
        iq[1::2] = scaled.astype(np.int16)
        return n_elems, iq


def make_source(query: str | dict, wire_format: str = "CS16") -> Source:
    """``verbose_device_search`` analog (convenience.c:469-489).

    Accepts the ``-d`` query string (``key=val,...``) or a pre-parsed dict.
    ``wire_format`` is the device stream format to request (rx_sdr's
    ``-I``, ``rtl_sdr.c:138,301``); it reaches real SoapySDR hardware via
    ``setupStream`` — framework sources always deliver the CS16 contract
    and file sources take their format from the query instead.
    """
    kw = parse_kwargs(query) if isinstance(query, str) else dict(query)
    if "file" in kw:
        p = _FileParams(
            path=kw["file"],
            format=kw.get("format", "CS16"),
            rate=atofs(kw.get("rate", "2048k")),
            loop=kw.get("loop", "0") not in ("0", "", "false"),
            format_pinned="format" in kw,
            rate_pinned="rate" in kw,
        )
        return FileSource(p)
    if "stdin" in kw:
        p = _FileParams(path="-", format=kw.get("format", "CU8"),
                        format_pinned="format" in kw)
        return FileSource(p)
    if "synth" in kw or kw.get("driver") == "synth":
        return SynthSource(kw)
    if "rtltcp" in kw or kw.get("driver") == "rtltcp":
        # network hardware path: rtl_tcp protocol client (iq/rtltcp.py)
        from rx_tools_tpu_torch.iq import rtltcp
        return rtltcp.RtlTcpSource(kw)
    if "driver" in kw:
        # hardware path: SoapySDR by driver query, exactly like the
        # reference's -d driver=rtlsdr (convenience.c:469-489)
        from rx_tools_tpu_torch.iq import soapy
        qstr = query if isinstance(query, str) else ",".join(
            f"{k}={v}" for k, v in kw.items())
        return soapy.SoapySource(qstr, wire_format=wire_format)
    # reference default: empty query = first available device
    return SynthSource({"synth": "noise", **kw})


def show_device_info(src: Source) -> None:
    """stderr capability dump, mirroring convenience.c:382-445.

    Hardware sources (SoapySource) report the full enumeration — hardware
    info kwargs, channel count, antennas, gain elements, frequency
    components, sample rates, bandwidths — in the reference's layout;
    framework sources print their simpler nominal capabilities.
    """
    info = src.info()
    if "num_channels" in info:           # real-hardware enumeration
        hw = " ".join(f"{k}={v}" for k, v in
                      info.get("hardware_info", {}).items())
        log("Using device %s: %s", info["hardware"], hw)
        log("Found %d channel(s) :", info["num_channels"])
        for c in range(info["num_channels"]):
            log("Channel %d :", c)
            log("  Found %d antenna(s): %s", len(info["antennas"]),
                " ".join(info["antennas"]))
            log("  Found %d gain(s): %s", len(info["gains"]),
                " ".join(info["gains"]))
            log("  Found %d frequencies: %s", len(info["frequencies"]),
                " ".join(info["frequencies"]))
            log("  Found %d sample rates: %s", len(info["sample_rates"]),
                " ".join("%.0f" % r for r in info["sample_rates"]))
            log("  Found %d bandwidths: %s", len(info["bandwidths"]),
                " ".join("%.0f" % b for b in info["bandwidths"]))
        return
    log("Using device %s: %s", info["driver"], info["hardware"])
    log("Found %d channel(s) :", 1)
    log("Antennas: %s", ", ".join(info["antennas"]))
    log("Gains: %s", ", ".join(info["gains"]))
    log("Frequency range: %.6f MHz - %.6f MHz",
        info["frequency_range"][0] / 1e6, info["frequency_range"][1] / 1e6)
    log("Sample rates: %s MS/s",
        ", ".join("%g" % (r / 1e6) for r in info["sample_rates"]))
