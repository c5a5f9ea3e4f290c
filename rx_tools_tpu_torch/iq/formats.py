"""I/Q sample formats and conversions.

Counterpart of :mod:`rx_tools_tpu.iq.formats`.  The five wire formats of
the reference (``src/rtl_sdr.c:73-95``):

========  =============================  ==========================
name      storage                        one complex sample
========  =============================  ==========================
CU8       uint8 interleaved              2 bytes
CS8       int8 interleaved               2 bytes
CS12      packed 12-bit signed           3 bytes
CS16      int16 interleaved              4 bytes
CF32      float32 interleaved            8 bytes
========  =============================  ==========================

Narrowing conversions replicate the reference bit-for-bit
(``src/rtl_sdr.c:348-391``), including the ``+0.4`` / ``+127.4`` rounding
biases with C truncation-toward-zero, and the CS12 3-bytes-to-2-samples
unpack (``src/rtl_sdr.c:354-366``).  The reference never widens (its device
always delivers CS16); the widening conversions here are the framework's own,
chosen to be exact left-inverses of the narrowing ones where possible.

Functions take either NumPy arrays or torch tensors and stay in the
matching namespace.  Host numpy arrays go through the native C++ codecs
when ``librx_native.so`` is built (:mod:`rx_tools_tpu_torch.native`), else
through NumPy.  Tensors, on the CPU or a CUDA device, run the float32
arithmetic of the NumPy path (divisions IEEE on every device, integer
stores wrapped explicitly), so a tensor and a numpy array give the same
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from rx_tools_tpu_torch import native as _native
from rx_tools_tpu_torch.ops.numeric import div_const

FORMATS = ("CU8", "CS8", "CS12", "CS16", "CF32")

#: bytes per complex sample (I+Q element), rtl_sdr.c "elem size"
ELEM_BYTES = {"CU8": 2, "CS8": 2, "CS12": 3, "CS16": 4, "CF32": 8}

_NP_DTYPE = {"CU8": np.uint8, "CS8": np.int8, "CS16": np.int16, "CF32": np.float32}

# float32 constants, rounded once on the host like the numpy path's
_F128 = float(np.float32(128.0))
_B04 = float(np.float32(0.4))
_B1274 = float(np.float32(127.4))
_CS16_SCALE = float(np.float32(128.0 / 32767.0))


def _use_native(x) -> bool:
    """Host numpy arrays go through the C++ codecs when built (parity is
    tested both ways in tests/test_torch_native.py)."""
    return isinstance(x, np.ndarray) and _native.available()


def parse_fmt(fmt: str) -> str:
    """Case-insensitive format name validation (rtl_sdr.c:73-95)."""
    f = fmt.upper()
    if f not in FORMATS:
        raise ValueError(f"Unsupported format: {fmt}")
    return f


def _narrow(x, bias: float, torch_dtype, np_dtype):
    """``(T)(int)(v / 32767.0 * 128.0 + bias)``: C truncation toward zero,
    then a wrapping integer store (a tensor goes float -> int32 -> T,
    because a direct float cast of an out-of-range value saturates on
    CUDA)."""
    if isinstance(x, torch.Tensor):
        v = torch.trunc(div_const(x.to(torch.float32), 32767.0) * _F128 + bias)
        return v.to(torch.int32).to(torch_dtype)
    v = np.trunc(x.astype(np.float32) / np.float32(32767.0) * np.float32(128.0)
                 + np.float32(bias))
    return v.astype(np_dtype)


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    """int32 -> int16 modulo 2**16, written out (C int16 store)."""
    v = v & 0xFFFF
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


# ---------------------------------------------------------------------------
# Narrowing (CS16 -> smaller), bit-faithful to rtl_sdr.c / rtl_fm.c
# ---------------------------------------------------------------------------

def cs16_to_cs8(x):
    """``(int16)v / 32767.0 * 128.0 + 0.4`` truncated (rtl_sdr.c:367-374)."""
    if _use_native(x):
        return _native.cs16_to_cs8(x.ravel()).reshape(x.shape)
    return _narrow(x, _B04, torch.int8, np.int8)


def cs16_to_cu8(x):
    """``(int16)v / 32767.0 * 128.0 + 127.4`` truncated (rtl_sdr.c:375-382)."""
    if _use_native(x):
        return _native.cs16_to_cu8(x.ravel()).reshape(x.shape)
    return _narrow(x, _B1274, torch.uint8, np.uint8)


def cs16_to_cf32(x):
    """``v / SHRT_MAX`` (rtl_sdr.c:383-391)."""
    if _use_native(x):
        return _native.cs16_to_cf32(x.ravel()).reshape(x.shape)
    if isinstance(x, torch.Tensor):
        return div_const(x.to(torch.float32), 32767.0)
    return x.astype(np.float32) / np.float32(32767.0)


def cs16_rescale8(x):
    """rx_fm capture rescale: int16 full-scale -> ±128-range **int16**.

    ``(int16_t)(buf[i] / 32767.0 * 128.0 + 0.4)`` — reference
    ``src/rtl_fm.c:845-848``.  Keeps rtl_fm's legacy 8-bit numerics while
    staying in int16 storage.
    """
    if _use_native(x):
        return _native.cs16_rescale8(x.ravel()).reshape(x.shape)
    return _narrow(x, _B04, torch.int16, np.int16)


def cs12_to_cs16(raw):
    """Unpack CS12: 3 bytes -> 2 int16 samples (rtl_sdr.c:354-366).

    ``s0 = (b1 << 12) | (b0 << 4)``; ``s1 = (b2 << 8) | (b1 & 0xf0)`` with
    int16 wraparound.  ``raw`` is a uint8 array of length divisible by 3.
    """
    if _use_native(raw):
        return _native.cs12_to_cs16(raw.ravel())
    if isinstance(raw, torch.Tensor):
        b = raw.reshape(-1, 3).to(torch.int32)
        s0 = (b[:, 1] << 12) | (b[:, 0] << 4)
        s1 = (b[:, 2] << 8) | (b[:, 1] & 0xF0)
        return _wrap16(torch.stack([s0, s1], dim=-1).reshape(-1))
    b = raw.reshape(-1, 3).astype(np.int32)
    s0 = (b[:, 1] << 12) | (b[:, 0] << 4)
    s1 = (b[:, 2] << 8) | (b[:, 1] & 0xF0)
    out = np.stack([s0, s1], axis=-1).reshape(-1)
    return out.astype(np.int16)  # wraps mod 2^16, matching C int16 store


def cs16_to_cs12(x):
    """Pack int16 pairs -> CS12 bytes; left-inverse of :func:`cs12_to_cs16`
    for values whose low 4 bits are zero (true 12-bit data)."""
    if _use_native(x):
        return _native.cs16_to_cs12(x.ravel())
    tensor = isinstance(x, torch.Tensor)
    v = (x.reshape(-1, 2).to(torch.int32) if tensor
         else x.reshape(-1, 2).astype(np.int32)) & 0xFFFF
    b0 = (v[:, 0] >> 4) & 0xFF
    b1 = ((v[:, 0] >> 12) & 0x0F) | (v[:, 1] & 0xF0)
    b2 = (v[:, 1] >> 8) & 0xFF
    if tensor:
        return torch.stack([b0, b1, b2], -1).reshape(-1).to(torch.uint8)
    return np.stack([b0, b1, b2], -1).reshape(-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# Widening (-> CS16).  Framework-defined: CU8/CS8 use the rtl-sdr driver
# idiom ((v - 128) << 8 / v << 8) for ecosystem compatibility with files
# produced by stock drivers.  NOTE this makes CU8 -> CS16 -> CU8 round
# trips off by at most 1 LSB against the reference's +127.4-biased
# narrowing (which its hardware-fed pipeline never composes with a widen);
# CS12 and CF32 round-trip exactly.
# ---------------------------------------------------------------------------

def cu8_to_cs16(x):
    """uint8 -> int16 full scale: ``(v - 128) << 8`` (rtl-sdr driver idiom)."""
    if _use_native(x):
        return _native.cu8_to_cs16(x.ravel()).reshape(x.shape)
    if isinstance(x, torch.Tensor):      # in range: -32768 .. 32512
        return ((x.to(torch.int32) - 128) * 256).to(torch.int16)
    return ((x.astype(np.int16) - 128) << 8).astype(np.int16)


def cs8_to_cs16(x):
    if _use_native(x):
        return _native.cs8_to_cs16(x.ravel()).reshape(x.shape)
    if isinstance(x, torch.Tensor):
        return (x.to(torch.int32) * 256).to(torch.int16)
    return (x.astype(np.int16) << 8).astype(np.int16)


def cf32_to_cs16(x):
    """``round(v * 32767)`` half to even, clipped to int16 (finite input;
    NaN has no defined result)."""
    if _use_native(x):
        return _native.cf32_to_cs16(x.ravel()).reshape(x.shape)
    if isinstance(x, torch.Tensor):
        v = torch.clamp(torch.round(x * 32767.0), -32768, 32767)
        return v.to(torch.int16)
    v = np.clip(np.round(x * np.float32(32767.0)), -32768, 32767)
    return v.astype(np.int16)


# ---------------------------------------------------------------------------
# Float internal representation: float32 in the ±128 "8-bit" range, so all
# reference magnitudes (squelch levels, output_scale, discriminator
# scaling) carry over unchanged.
# ---------------------------------------------------------------------------

def to_float(x, fmt: str):
    """Decode a raw buffer of ``fmt`` into interleaved float32, ±128 range."""
    fmt = parse_fmt(fmt)
    if fmt == "CS12":
        x, fmt = cs12_to_cs16(x), "CS16"
    f = (x.to(torch.float32) if isinstance(x, torch.Tensor)
         else x.astype(np.float32))
    if fmt == "CU8":
        return f - _B1274
    if fmt == "CS8":
        return f
    if fmt == "CS16":
        return f * _CS16_SCALE
    return f * _F128                                         # CF32


def convert(x, in_fmt: str, out_fmt: str):
    """General format conversion.

    The reference restricts pairs to {identity, CS16->anything, CS12->CS16}
    (rtl_sdr.c:202-208); this framework supports the full matrix by widening
    through CS16 first.  The restricted pairs reproduce the reference output
    bit-for-bit.
    """
    in_fmt, out_fmt = parse_fmt(in_fmt), parse_fmt(out_fmt)
    if in_fmt == out_fmt:
        return x
    wide = {"CU8": cu8_to_cs16, "CS8": cs8_to_cs16, "CS12": cs12_to_cs16,
            "CF32": cf32_to_cs16, "CS16": lambda v: v}[in_fmt](x)
    return {"CU8": cs16_to_cu8, "CS8": cs16_to_cs8, "CS12": cs16_to_cs12,
            "CF32": cs16_to_cf32, "CS16": lambda v: v}[out_fmt](wide)


def bytes_to_array(buf: bytes, fmt: str) -> np.ndarray:
    """Raw bytes -> interleaved sample array (host side)."""
    fmt = parse_fmt(fmt)
    if fmt == "CS12":
        return np.frombuffer(buf, dtype=np.uint8)
    return np.frombuffer(buf, dtype=_NP_DTYPE[fmt])


def array_to_bytes(x, fmt: str) -> bytes:
    """Interleaved samples (numpy array or tensor) -> raw bytes."""
    fmt = parse_fmt(fmt)
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    want = np.uint8 if fmt == "CS12" else _NP_DTYPE[fmt]
    return np.asarray(x, dtype=want).tobytes()
