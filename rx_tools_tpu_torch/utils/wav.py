"""Streaming WAV header (RIFF/WAVE, 16-bit PCM).

Parity with ``generate_header`` (reference ``src/rtl_fm.c:1174-1206``): sizes
are written as 0xFFFFFFFF so a killed stream remains playable; raw/IQ mode is
stereo with 4-byte block align, everything else mono with 2-byte align.
"""

from __future__ import annotations

import struct
from typing import BinaryIO


def wav_header(rate: int, stereo: bool = False) -> bytes:
    channels = 2 if stereo else 1
    align = 4 if stereo else 2
    byte_rate = rate * align
    return b"".join([
        b"RIFF", b"\xff\xff\xff\xff", b"WAVE",
        b"fmt ", struct.pack("<I", 16),
        struct.pack("<H", 1),            # PCM
        struct.pack("<H", channels),
        struct.pack("<I", rate),
        struct.pack("<I", byte_rate),
        struct.pack("<H", align),
        struct.pack("<H", 16),           # bits per sample
        b"data", b"\xff\xff\xff\xff",
    ])


def write_wav_header(f: BinaryIO, rate: int, stereo: bool = False) -> None:
    f.write(wav_header(rate, stereo))
