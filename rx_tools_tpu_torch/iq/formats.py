"""I/Q wire formats the sources read, widened to CS16 on the host (numpy).

The reference's five wire formats (``src/rtl_sdr.c:73-95``) are
recognised; the rx_fm chain reads CS16 and CU8 captures, whose widening to
CS16 is here.  The other formats, and every narrowing conversion, belong
to the rx_sdr slice and raise until it is ported.
"""

from __future__ import annotations

import numpy as np

FORMATS = ("CU8", "CS8", "CS12", "CS16", "CF32")

#: the formats this port reads so far
READABLE = ("CU8", "CS16")

#: bytes per complex sample (I+Q element), rtl_sdr.c "elem size"
ELEM_BYTES = {"CU8": 2, "CS8": 2, "CS12": 3, "CS16": 4, "CF32": 8}


def parse_fmt(fmt: str) -> str:
    """Case-insensitive format name validation (rtl_sdr.c:73-95)."""
    f = fmt.upper()
    if f not in FORMATS:
        raise ValueError(f"Unsupported format: {fmt}")
    return f


def require_readable(fmt: str) -> str:
    """``fmt`` validated, or NotImplementedError for a format not ported."""
    f = parse_fmt(fmt)
    if f not in READABLE:
        raise NotImplementedError(
            f"{f} input is not yet ported (rx_sdr slice); use CS16 or CU8")
    return f


def cu8_to_cs16(x: np.ndarray) -> np.ndarray:
    """uint8 -> int16 full scale: ``(v - 128) << 8`` (rtl-sdr driver idiom)."""
    return ((x.astype(np.int16) - 128) << 8).astype(np.int16)


def bytes_to_cs16(buf: bytes, fmt: str) -> np.ndarray:
    """Raw bytes of a readable format -> interleaved CS16."""
    fmt = require_readable(fmt)
    if fmt == "CU8":
        return cu8_to_cs16(np.frombuffer(buf, dtype=np.uint8))
    return np.frombuffer(buf, dtype=np.int16)
