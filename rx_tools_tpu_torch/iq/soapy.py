"""Real-hardware source: SoapySDR via ctypes (no compiled extension).

Counterpart of :mod:`rx_tools_tpu.iq.soapy`; host code, blocks arrive as
numpy arrays.  The reference's only hardware path is the SoapySDR C API
(``src/convenience/convenience.c:469-513``, stream I/O
``src/rtl_fm.c:870-899``).  This module binds the same C API with ctypes
so any SoapySDR-supported radio feeds the CUDA pipelines — completing the
``-d driver=rtlsdr`` / ``driver=hackrf`` surface of the reference CLIs.

Bound surface (matching what the reference actually calls):

- make/unmake, setupStream (both API vintages, ``convenience.c:500-511``)
  with channel-count validation (``convenience.c:495-499``),
- every setter the ``verbose_*`` layer uses, plus ``readSetting`` so
  direct-sampling / offset-tuning readback verification
  (``convenience.c:196-208,226-233``) runs against the hardware,
- the ``show_device_info`` enumeration getters
  (``convenience.c:382-445``): hardware key/info, channels, antennas,
  gain elements, frequency components, sample rates, bandwidths,
- ``SoapySDRDevice_lastError`` / ``SoapySDR_errToStr`` for diagnostics
  (``rtl_sdr.c:330-339``),
- per-driver auto-gain quirks via ``getDriverKey``
  (``convenience.c:238-285``: RTLSDR -> 40 dB, HackRF -> LNA 40 / VGA 20 /
  AMP 0, anything else left to driver defaults).

Gated: :func:`available` is False when ``libSoapySDR.so`` is absent;
``make_source`` then reports a clear error for ``driver=`` queries.
rx_fm and rx_power request CS16, the wire format the reference requests
(``rtl_fm.c:1395``, ``rtl_power.c:975``); rx_sdr requests its ``-I``
format (``rtl_sdr.c:301``).  Tested hardware-free
against a fake ``libSoapySDR`` (tests/fake_soapy.cpp), both ABI vintages.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from rx_tools_tpu_torch.iq.sources import Source, ERR_OVERFLOW, ERR_TIMEOUT
from rx_tools_tpu_torch.utils.logging import log

_LIB = None
_TRIED = False
_LIBC = ctypes.CDLL(None)
_LIBC.free.argtypes = [ctypes.c_void_p]
_LIBC.free.restype = None

_SOAPY_SDR_RX = 1


class _Kwargs(ctypes.Structure):
    """SoapySDRKwargs (Types.h): sized key/value string lists."""

    _fields_ = [("size", ctypes.c_size_t),
                ("keys", ctypes.POINTER(ctypes.c_char_p)),
                ("vals", ctypes.POINTER(ctypes.c_char_p))]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    name = ctypes.util.find_library("SoapySDR")
    for cand in ([name] if name else []) + ["libSoapySDR.so", "libSoapySDR.so.0.8"]:
        try:
            _LIB = ctypes.CDLL(cand)
            break
        except OSError:
            continue
    if _LIB is not None:
        _bind(_LIB)
    return _LIB


def _bind(lib):
    p = ctypes.c_void_p
    sz = ctypes.c_size_t
    ch = ctypes.c_int
    lib.SoapySDRDevice_makeStrArgs.argtypes = [ctypes.c_char_p]
    lib.SoapySDRDevice_makeStrArgs.restype = p
    lib.SoapySDRDevice_unmake.argtypes = [p]
    for name, args in [
        ("SoapySDRDevice_setSampleRate", [p, ch, sz, ctypes.c_double]),
        ("SoapySDRDevice_setFrequency", [p, ch, sz, ctypes.c_double, p]),
        ("SoapySDRDevice_setBandwidth", [p, ch, sz, ctypes.c_double]),
        ("SoapySDRDevice_setGain", [p, ch, sz, ctypes.c_double]),
        ("SoapySDRDevice_setGainElement", [p, ch, sz, ctypes.c_char_p,
                                           ctypes.c_double]),
        ("SoapySDRDevice_setGainMode", [p, ch, sz, ctypes.c_bool]),
        ("SoapySDRDevice_setAntenna", [p, ch, sz, ctypes.c_char_p]),
        ("SoapySDRDevice_setFrequencyCorrection", [p, ch, sz,
                                                   ctypes.c_double]),
        ("SoapySDRDevice_writeSetting", [p, ctypes.c_char_p, ctypes.c_char_p]),
        ("SoapySDRDevice_activateStream", [p, p, ch, ctypes.c_longlong, sz]),
        ("SoapySDRDevice_deactivateStream", [p, p, ch, ctypes.c_longlong]),
        ("SoapySDRDevice_closeStream", [p, p]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.SoapySDRDevice_getFrequency.argtypes = [p, ch, sz]
    lib.SoapySDRDevice_getFrequency.restype = ctypes.c_double
    lib.SoapySDRDevice_readStream.argtypes = [
        p, p, ctypes.POINTER(p), sz, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_long]
    lib.SoapySDRDevice_readStream.restype = ctypes.c_int
    # --- introspection (show_device_info, convenience.c:382-445) ----------
    for name in ("SoapySDRDevice_getDriverKey",
                 "SoapySDRDevice_getHardwareKey"):
        fn = getattr(lib, name)
        fn.argtypes = [p]
        fn.restype = p                      # malloc'd char*, caller frees
    lib.SoapySDRDevice_getHardwareInfo.argtypes = [p]
    lib.SoapySDRDevice_getHardwareInfo.restype = _Kwargs
    lib.SoapySDRDevice_getNumChannels.argtypes = [p, ch]
    lib.SoapySDRDevice_getNumChannels.restype = sz
    for name in ("SoapySDRDevice_listAntennas", "SoapySDRDevice_listGains",
                 "SoapySDRDevice_listFrequencies"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ch, sz, ctypes.POINTER(sz)]
        fn.restype = ctypes.POINTER(ctypes.c_char_p)
    for name in ("SoapySDRDevice_listSampleRates",
                 "SoapySDRDevice_listBandwidths"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ch, sz, ctypes.POINTER(sz)]
        fn.restype = ctypes.POINTER(ctypes.c_double)
    lib.SoapySDRDevice_readSetting.argtypes = [p, ctypes.c_char_p]
    lib.SoapySDRDevice_readSetting.restype = p  # malloc'd char*
    lib.SoapySDRDevice_lastError.argtypes = []
    lib.SoapySDRDevice_lastError.restype = ctypes.c_char_p  # static buffer
    lib.SoapySDR_errToStr.argtypes = [ctypes.c_int]
    lib.SoapySDR_errToStr.restype = ctypes.c_char_p         # static string
    # --- setupStream: dual ABI (convenience.c:500-511) ---------------------
    try:
        lib.SoapySDR_getAPIVersion.argtypes = []
        lib.SoapySDR_getAPIVersion.restype = ctypes.c_char_p
        ver = lib.SoapySDR_getAPIVersion().decode()
        parts = ver.split(".")
        lib._modern_abi = (int(parts[0]), int(parts[1])) >= (0, 8)
    except (AttributeError, ValueError, IndexError):
        lib._modern_abi = False
    if lib._modern_abi:
        lib.SoapySDRDevice_setupStream.argtypes = [
            p, ch, ctypes.c_char_p, ctypes.POINTER(sz), sz, p]
        lib.SoapySDRDevice_setupStream.restype = p
    else:
        lib.SoapySDRDevice_setupStream.argtypes = [
            p, ctypes.POINTER(p), ch, ctypes.c_char_p, ctypes.POINTER(sz),
            sz, p]
        lib.SoapySDRDevice_setupStream.restype = ctypes.c_int


def available() -> bool:
    return _load() is not None


def _take_str(ptr) -> str:
    """Copy a malloc'd C string and free it (the reference free()s the
    returns of getDriverKey/readSetting, convenience.c:211,288)."""
    if not ptr:
        return ""
    s = ctypes.string_at(ptr).decode(errors="replace")
    _LIBC.free(ptr)
    return s


def last_error(lib=None) -> str:
    lib = lib or _LIB
    e = lib.SoapySDRDevice_lastError()
    return e.decode(errors="replace") if e else ""


def err_to_str(code: int, lib=None) -> str:
    lib = lib or _LIB
    s = lib.SoapySDR_errToStr(int(code))
    return s.decode(errors="replace") if s else str(code)


class SoapySource(Source):
    """A SoapySDR device as a block source.

    ``wire_format`` is the format requested from the device via
    ``setupStream`` — the reference's rx_sdr passes its ``-I`` format
    straight through (``rtl_sdr.c:138,176,301``) so e.g. a native 12-bit
    radio delivers CS12 on the wire; rx_fm/rx_power always request CS16
    (``rtl_fm.c:1395``, ``rtl_power.c:975``).  :meth:`read_stream`
    converts any wire format to the framework's CS16 contract;
    :meth:`read_stream_raw` exposes the undecoded wire data for rx_sdr's
    passthrough/convert loop (``rtl_sdr.c:348-391``)."""

    driver = "soapy"

    def __init__(self, query: str, channel: int = 0,
                 wire_format: str = "CS16"):
        super().__init__()
        from rx_tools_tpu_torch.iq import formats as _formats
        self.wire_format = _formats.parse_fmt(wire_format)
        self._elem_bytes = _formats.ELEM_BYTES[self.wire_format]
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "SoapySDR library not found; hardware sources need "
                "libSoapySDR installed (file=/synth= sources work without it)")
        self._lib = lib
        self._dev = lib.SoapySDRDevice_makeStrArgs(query.encode())
        if not self._dev:
            raise RuntimeError(f"SoapySDRDevice_makeStrArgs failed for {query!r}")
        self.channel = channel
        self.driver = _take_str(lib.SoapySDRDevice_getDriverKey(self._dev))
        self.hardware = _take_str(lib.SoapySDRDevice_getHardwareKey(self._dev))
        # channel-count validation before stream setup (convenience.c:495-499)
        num = int(lib.SoapySDRDevice_getNumChannels(self._dev, _SOAPY_SDR_RX))
        if channel >= num:
            lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None
            raise RuntimeError(f"Invalid channel {channel} selected "
                               f"(device has {num})")
        chan = ctypes.c_size_t(channel)
        fmt = self.wire_format.encode()
        if lib._modern_abi:
            self._stream = lib.SoapySDRDevice_setupStream(
                self._dev, _SOAPY_SDR_RX, fmt, ctypes.byref(chan), 1, None)
            ok = bool(self._stream)
        else:
            stream = ctypes.c_void_p()
            r = lib.SoapySDRDevice_setupStream(
                self._dev, ctypes.byref(stream), _SOAPY_SDR_RX, fmt,
                ctypes.byref(chan), 1, None)
            self._stream = stream.value
            ok = (r == 0)
        if not ok:
            err = last_error(lib)
            lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None
            raise RuntimeError(f"SoapySDRDevice_setupStream failed: {err}")

    # -- configuration -----------------------------------------------------
    def set_sample_rate(self, rate):
        super().set_sample_rate(rate)
        return self._lib.SoapySDRDevice_setSampleRate(
            self._dev, _SOAPY_SDR_RX, self.channel, float(rate))

    def set_frequency(self, freq):
        super().set_frequency(freq)
        return self._lib.SoapySDRDevice_setFrequency(
            self._dev, _SOAPY_SDR_RX, self.channel, float(freq), None)

    def get_frequency(self):
        return self._lib.SoapySDRDevice_getFrequency(
            self._dev, _SOAPY_SDR_RX, self.channel)

    def set_bandwidth(self, bw):
        super().set_bandwidth(bw)
        return self._lib.SoapySDRDevice_setBandwidth(
            self._dev, _SOAPY_SDR_RX, self.channel, float(bw))

    def set_gain(self, value):
        super().set_gain(value)
        return self._lib.SoapySDRDevice_setGain(
            self._dev, _SOAPY_SDR_RX, self.channel, float(value))

    def set_gain_element(self, name, value):
        super().set_gain_element(name, value)
        return self._lib.SoapySDRDevice_setGainElement(
            self._dev, _SOAPY_SDR_RX, self.channel, name.encode(), float(value))

    def set_gain_mode(self, automatic: bool) -> int:
        """``SoapySDRDevice_setGainMode`` — the reference's mechanism for
        ``-E rtlagc/agc`` (rtl_fm.c:1432), called on the real device
        (a ``digital_agc`` setting write would only reach SoapyRTLSDR's
        private key)."""
        return self._lib.SoapySDRDevice_setGainMode(
            self._dev, _SOAPY_SDR_RX, self.channel, bool(automatic))

    def set_auto_gain(self):
        """Per-driver auto-gain quirks (convenience.c:238-285)."""
        if self.driver == "RTLSDR":
            r = self._lib.SoapySDRDevice_setGain(
                self._dev, _SOAPY_SDR_RX, self.channel, 40.0)
            if r != 0:
                log("WARNING: Failed to set tuner gain: %s",
                    last_error(self._lib))
            else:
                log("Tuner gain semi-automatically set to 40 dB")
            return r
        if self.driver == "HackRF":
            r = 0
            for name, value in (("LNA", 40.0), ("VGA", 20.0), ("AMP", 0.0)):
                ri = self.set_gain_element(name, value)
                if ri != 0:
                    log("WARNING: Failed to set %s tuner gain: %s", name,
                        last_error(self._lib))
                r = ri
            return r
        # otherwise leave unset, hopefully the driver has good defaults
        log("Using automatic gain control.")
        return 0

    def set_antenna(self, name):
        super().set_antenna(name)
        return self._lib.SoapySDRDevice_setAntenna(
            self._dev, _SOAPY_SDR_RX, self.channel, name.encode())

    def set_frequency_correction(self, ppm):
        super().set_frequency_correction(ppm)
        return self._lib.SoapySDRDevice_setFrequencyCorrection(
            self._dev, _SOAPY_SDR_RX, self.channel, float(ppm))

    def write_setting(self, key, value):
        super().write_setting(key, value)
        return self._lib.SoapySDRDevice_writeSetting(
            self._dev, key.encode(), value.encode())

    def read_setting(self, key):
        """True hardware readback (convenience.c:196,228) — None when the
        driver rejects the key, so verbose_* readback verification can
        surface misconfigured hardware."""
        ptr = self._lib.SoapySDRDevice_readSetting(self._dev, key.encode())
        return _take_str(ptr) if ptr else None

    # -- enumeration (show_device_info, convenience.c:382-445) --------------
    def _str_list(self, fn):
        n = ctypes.c_size_t(0)
        arr = fn(self._dev, _SOAPY_SDR_RX, self.channel, ctypes.byref(n))
        return [arr[i].decode(errors="replace") for i in range(n.value)]

    def _dbl_list(self, fn):
        n = ctypes.c_size_t(0)
        arr = fn(self._dev, _SOAPY_SDR_RX, self.channel, ctypes.byref(n))
        return [float(arr[i]) for i in range(n.value)]

    def info(self) -> dict:
        lib = self._lib
        kw = lib.SoapySDRDevice_getHardwareInfo(self._dev)
        hw_info = {kw.keys[i].decode(errors="replace"):
                   kw.vals[i].decode(errors="replace")
                   for i in range(kw.size)}
        rates = self._dbl_list(lib.SoapySDRDevice_listSampleRates)
        return {
            "driver": self.driver,
            "hardware": self.hardware,
            "hardware_info": hw_info,
            "num_channels": int(lib.SoapySDRDevice_getNumChannels(
                self._dev, _SOAPY_SDR_RX)),
            "antennas": self._str_list(lib.SoapySDRDevice_listAntennas),
            "gains": self._str_list(lib.SoapySDRDevice_listGains),
            "frequencies": self._str_list(lib.SoapySDRDevice_listFrequencies),
            "frequency_range": (0.0, 6e9),
            "sample_rates": rates,
            "bandwidths": self._dbl_list(lib.SoapySDRDevice_listBandwidths),
        }

    # -- streaming ---------------------------------------------------------
    def activate(self):
        r = self._lib.SoapySDRDevice_activateStream(
            self._dev, self._stream, 0, 0, 0)
        if r != 0:
            log("WARNING: Failed to activate stream: %s (%s)",
                err_to_str(r, self._lib), last_error(self._lib))
        return r

    def deactivate(self):
        self._lib.SoapySDRDevice_deactivateStream(self._dev, self._stream, 0, 0)

    def read_stream_raw(self, n_elems):
        """Read up to ``n_elems`` complex samples in the WIRE format.

        Returns ``(count, buf)`` with ``buf`` typed per format: int16
        (CS16), int8 (CS8), uint8 (CU8; also CS12 — packed 3 bytes per
        sample), float32 (CF32).  The raw path rx_sdr's passthrough and
        unpack branches consume (``rtl_sdr.c:348-366``)."""
        nbytes = n_elems * self._elem_bytes
        buf = np.empty(nbytes, np.uint8)
        bufp = ctypes.c_void_p(buf.ctypes.data)
        flags = ctypes.c_int(0)
        time_ns = ctypes.c_longlong(0)
        r = self._lib.SoapySDRDevice_readStream(
            self._dev, self._stream, ctypes.byref(bufp), n_elems,
            ctypes.byref(flags), ctypes.byref(time_ns), 1_000_000)
        if r < 0:
            # SOAPY_SDR_OVERFLOW == -4, TIMEOUT == -1: the caller's soft
            # codes; everything else is surfaced with its error string
            # (rtl_sdr.c:338-339 "WARNING: sync read failed")
            if r == -4:
                return ERR_OVERFLOW, buf[:0]
            if r != -1:
                log("WARNING: sync read failed. %d (%s)", r,
                    err_to_str(r, self._lib))
            return ERR_TIMEOUT, buf[:0]
        raw = buf[: r * self._elem_bytes]
        if self.wire_format in ("CU8", "CS12"):
            return r, raw
        dt = {"CS16": np.int16, "CS8": np.int8,
              "CF32": np.float32}[self.wire_format]
        return r, raw.view(dt)

    def read_stream(self, n_elems):
        """CS16-contract read: wire data converted at read when the stream
        was set up with a non-CS16 ``wire_format`` (bit-exact CS12 unpack,
        reference bias semantics via iq.formats)."""
        r, raw = self.read_stream_raw(n_elems)
        if r <= 0 or self.wire_format == "CS16":
            return r, (raw if self.wire_format == "CS16"
                       else np.empty(0, np.int16))
        from rx_tools_tpu_torch.iq import formats
        return r, np.asarray(formats.convert(raw, self.wire_format, "CS16"),
                             np.int16)

    def close(self):
        if getattr(self, "_stream", None):
            self._lib.SoapySDRDevice_closeStream(self._dev, self._stream)
            self._stream = None
        if getattr(self, "_dev", None):
            self._lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None
