"""RIFF/WAVE header parsing for I/Q capture replay.

``rx_fm -E wav`` (and the reference, ``src/rtl_fm.c:1174-1206``) writes
WAV captures — raw I/Q mode as stereo 16-bit with 0xFFFFFFFF stream sizes
so a killed stream stays playable.  This reads them back: a ``-d
file=capture.wav`` source auto-detects the header, takes the sample rate
and format from it, and streams the data chunk.  Chunk sizes of
0xFFFFFFFF (or truncated files) mean "to EOF", matching the writer.
"""

from __future__ import annotations

import struct
from typing import Callable, NamedTuple


class WavInfo(NamedTuple):
    rate: int
    channels: int
    bits: int

    @property
    def iq_format(self) -> str:
        """Map to the framework's wire formats; I/Q WAVs are 2-channel."""
        if self.channels != 2:
            raise ValueError(
                f"WAV has {self.channels} channel(s); I/Q replay needs 2 "
                "(rx_fm -E wav raw mode writes stereo)")
        if self.bits == 16:
            return "CS16"
        if self.bits == 8:
            return "CU8"
        raise ValueError(f"unsupported WAV bit depth {self.bits}")


def parse_wav(read: Callable[[int], bytes]):
    """Incrementally parse a WAV header from ``read(n)``.

    Returns ``(WavInfo, consumed)`` positioned at the data chunk's first
    byte, or ``(None, consumed)`` if the stream is not RIFF/WAVE —
    ``consumed`` holds every byte read either way, so a non-WAV caller can
    replay them.
    """
    consumed = b""

    def take(n: int) -> bytes:
        nonlocal consumed
        b = b""
        while len(b) < n:
            chunk = read(n - len(b))
            if not chunk:
                break
            b += chunk
        consumed += b
        return b

    head = take(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        return None, consumed

    info = None
    while True:
        hdr = take(8)
        if len(hdr) < 8:
            raise ValueError("WAV header ends before a data chunk")
        tag = hdr[:4]
        size = struct.unpack("<I", hdr[4:])[0]
        if tag == b"fmt ":
            body = take(size + (size & 1))
            fmt_code, channels, rate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if fmt_code != 1:
                raise ValueError(f"non-PCM WAV (format {fmt_code})")
            info = WavInfo(rate=rate, channels=channels, bits=bits)
        elif tag == b"data":
            if info is None:
                raise ValueError("WAV data chunk before fmt chunk")
            return info, consumed
        else:
            take(size + (size & 1))        # skip LIST/INFO/etc.
