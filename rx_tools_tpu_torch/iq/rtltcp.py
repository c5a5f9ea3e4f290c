"""rtl_tcp network source — remote hardware over a plain TCP socket.

Counterpart of :mod:`rx_tools_tpu.iq.rtltcp`.  The reference descopes
networking entirely: "For network support, use SoapyRemote"
(``README.md:30``).  That leaves a GPU server — which has no USB radio and
often no SoapySDR library — with no hardware path at all.  This module
adds one with zero dependencies: a client for the **rtl_tcp protocol**
(librtlsdr's network server, also spoken by SDRplay/Airspy bridges and SDR
servers like rtl_tcp-compatible KiwiSDR frontends), so a $30 dongle on any
host on the network feeds the CUDA DSP chain.  It is host code: blocks
arrive as numpy arrays.

Wire protocol (fixed by librtlsdr's ``rtl_tcp.c``, stable since 2012):

- server → client, once: a 12-byte header ``"RTL0"`` magic + ``u32be``
  tuner type + ``u32be`` tuner gain count;
- server → client, forever: interleaved **CU8** I/Q samples;
- client → server: 5-byte commands, ``u8`` opcode + ``u32be`` argument.

The opcode map below mirrors the Source/verbose_* surface the reference
drives through SoapySDR (``src/convenience/convenience.c:138-380``): the
same CLI flags (``-f -s -g -p -E direct/offset/agc``) reach the remote
dongle.  Incoming CU8 is converted to the framework's CS16 wire contract
by the exact rx_sdr semantics (``src/rtl_sdr.c:375-382`` inverse path —
see iq/formats.py).
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from rx_tools_tpu_torch.iq import formats
from rx_tools_tpu_torch.iq.sources import ERR_TIMEOUT, Source
from rx_tools_tpu_torch.utils.logging import log

# librtlsdr rtl_tcp.c command set
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03          # 0 = auto, 1 = manual
CMD_SET_GAIN = 0x04               # tenths of dB
CMD_SET_FREQ_CORRECTION = 0x05    # ppm
CMD_SET_IF_GAIN = 0x06            # (stage << 16) | gain
CMD_SET_TEST_MODE = 0x07
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A
CMD_SET_RTL_XTAL = 0x0B
CMD_SET_TUNER_XTAL = 0x0C
CMD_SET_TUNER_GAIN_BY_INDEX = 0x0D
CMD_SET_BIAS_TEE = 0x0E

#: rtl_tcp dongle_info.tuner_type values (librtlsdr rtlsdr_get_tuner_type)
TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}

MAGIC = b"RTL0"
DEFAULT_PORT = 1234


class RtlTcpSource(Source):
    """A remote rtl_tcp server as a block source.

    kwargs (from ``-d rtltcp=host[:port]`` or
    ``-d driver=rtltcp,host=...,port=...``):

    - ``host`` / ``port``  — server address (default localhost:1234)
    - ``timeout``          — socket timeout seconds (default 5)
    """

    driver = "rtltcp"

    def __init__(self, kwargs: dict[str, str]):
        super().__init__()
        addr = kwargs.get("rtltcp") or kwargs.get("host") or "localhost"
        if ":" in addr:
            host, _, port_s = addr.rpartition(":")
            port = int(port_s)
        else:
            host, port = addr, int(kwargs.get("port", DEFAULT_PORT))
        self._timeout = float(kwargs.get("timeout", "5"))
        self._sock = socket.create_connection((host, port),
                                              timeout=self._timeout)
        self._sock.settimeout(self._timeout)
        self._pending = b""
        self._eof = False

        header = self._recv_exact(12)
        if header is None or header[:4] != MAGIC:
            self._sock.close()
            raise ConnectionError(
                f"{host}:{port} is not an rtl_tcp server "
                f"(bad magic {header[:4]!r})" if header else
                f"{host}:{port} closed before sending the rtl_tcp header")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:])
        self.hardware = "rtl_tcp %s:%d tuner=%s" % (
            host, port, TUNER_NAMES.get(self.tuner_type,
                                        str(self.tuner_type)))
        log("Found rtl_tcp server at %s:%d (tuner %s, %d gain steps)",
            host, port, TUNER_NAMES.get(self.tuner_type, "?"),
            self.tuner_gain_count)

    # -- protocol ------------------------------------------------------------
    def _command(self, opcode: int, arg: int) -> int:
        try:
            self._sock.sendall(struct.pack(">BI", opcode, arg & 0xFFFFFFFF))
            return 0
        except OSError as e:
            log("rtl_tcp command 0x%02x failed: %s", opcode, e)
            return -1

    def _recv_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- configuration (verbose_* surface → rtl_tcp opcodes) ------------------
    def set_frequency(self, freq: float) -> int:
        super().set_frequency(freq)
        return self._command(CMD_SET_FREQ, int(round(freq)))

    def set_sample_rate(self, rate: float) -> int:
        super().set_sample_rate(rate)
        return self._command(CMD_SET_SAMPLE_RATE, int(round(rate)))

    def set_gain(self, value: float) -> int:
        super().set_gain(value)
        # SoapySDR gains are dB; rtl_tcp takes tenths of dB, manual mode
        r = self._command(CMD_SET_GAIN_MODE, 1)
        return r or self._command(CMD_SET_GAIN, int(round(value * 10)))

    def set_gain_element(self, name: str, value: float) -> int:
        super().set_gain_element(name, value)
        if name.upper() == "IF":
            return self._command(CMD_SET_IF_GAIN,
                                 (1 << 16) | (int(round(value * 10)) & 0xFFFF))
        return self.set_gain(value)

    def set_auto_gain(self) -> int:
        """The reference's RTLSDR auto-gain quirk (``verbose_auto_gain``,
        ``src/convenience/convenience.c:253-262``): rtl_tcp serves an
        RTL-SDR, so 'auto' means the same "semi-automatic" 40 dB."""
        r = self._command(CMD_SET_GAIN_MODE, 1)
        r = r or self._command(CMD_SET_GAIN, 400)
        if r == 0:
            log("Tuner gain semi-automatically set to 40 dB")
        return r

    def set_frequency_correction(self, ppm: float) -> int:
        super().set_frequency_correction(ppm)
        return self._command(CMD_SET_FREQ_CORRECTION, int(round(ppm)))

    def set_gain_mode(self, automatic: bool) -> int:
        """The wire-level analog of ``SoapySDRDevice_setGainMode`` for
        ``-E rtlagc/agc``: rtl_tcp's native ``CMD_SET_AGC_MODE`` opcode
        (a ``digital_agc`` setting write would be dropped by
        :meth:`write_setting` while the CLI logged success)."""
        super().set_gain_mode(automatic)
        return self._command(CMD_SET_AGC_MODE, int(bool(automatic)))

    def write_setting(self, key: str, value: str) -> int:
        super().write_setting(key, value)
        truthy = str(value).lower() not in ("0", "false", "")
        if key == "direct_samp":
            return self._command(CMD_SET_DIRECT_SAMPLING, int(value or 0))
        if key == "offset_tune":
            return self._command(CMD_SET_OFFSET_TUNING, int(truthy))
        if key in ("rtlagc", "agc", "agc_mode"):
            return self._command(CMD_SET_AGC_MODE, int(truthy))
        if key == "testmode":
            return self._command(CMD_SET_TEST_MODE, int(truthy))
        if key == "biastee":
            return self._command(CMD_SET_BIAS_TEE, int(truthy))
        if key == "gain_index":
            return self._command(CMD_SET_TUNER_GAIN_BY_INDEX, int(value))
        log("rtl_tcp: ignoring unsupported setting %s=%s", key, value)
        return 0

    # -- streaming -----------------------------------------------------------
    def read_stream(self, n_elems: int) -> tuple[int, np.ndarray]:
        """Read up to ``n_elems`` complex samples (2 CU8 bytes each) and
        convert to the CS16 contract.  Returns what arrived on timeout
        (ERR_TIMEOUT if nothing), 0 on server EOF."""
        need = 2 * n_elems
        buf = self._pending
        while len(buf) < need and not self._eof:
            try:
                chunk = self._sock.recv(need - len(buf))
            except socket.timeout:
                break
            if not chunk:
                self._eof = True
                break
            buf += chunk
        n = min(len(buf) // 2, n_elems)
        self._pending = buf[2 * n:]
        if n == 0:
            return (0 if self._eof else ERR_TIMEOUT), np.empty(0, np.int16)
        raw = formats.bytes_to_array(buf[: 2 * n], "CU8")
        cs16 = formats.convert(raw, "CU8", "CS16")
        return n, np.asarray(cs16, np.int16)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def info(self) -> dict:
        d = super().info()
        d["tuner"] = TUNER_NAMES.get(self.tuner_type, str(self.tuner_type))
        d["gains"] = ["TUNER", "IF"]
        return d
