"""Native C++ host runtime, loaded via ctypes.

Counterpart of :mod:`rx_tools_tpu.native`, built from its own copy of the
sources (``src/``):

- ``iqcodec``: wire-format codecs with the reference's exact narrowing
  semantics — the rx_sdr convert hot loop (``src/rtl_sdr.c:348-391``) as
  auto-vectorized C++.
- ``ringbuf``: bounded ring-buffer block feeder — the dongle-thread analog
  (``src/rtl_fm.c:866-914``) with explicit overflow accounting instead of
  the reference's silent single-buffer overwrite.

This is host code: nothing here touches the CUDA device.  The library is
optional: :func:`available` is False while ``build/native/librx_native.so``
(at the root of the checkout) is missing — build it with ``python -m
rx_tools_tpu_torch.native.build`` — and callers then use the NumPy paths,
which give the same bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
#: where ``build.py`` writes the library: ``build/native/`` at the root
LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                        "native", "librx_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.path.exists(LIB_PATH):
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError:
            return None
        _bind(lib)
        _LIB = lib
    return _LIB


def _bind(lib):
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    for name, args, res in [
        ("rx_cs16_to_cs8", [p, p, i64], None),
        ("rx_cs16_to_cu8", [p, p, i64], None),
        ("rx_cs16_to_cf32", [p, p, i64], None),
        ("rx_cs16_rescale8", [p, p, i64], None),
        ("rx_cu8_to_cs16", [p, p, i64], None),
        ("rx_cs8_to_cs16", [p, p, i64], None),
        ("rx_cf32_to_cs16", [p, p, i64], None),
        ("rx_cs12_to_cs16", [p, p, i64], None),
        ("rx_cs16_to_cs12", [p, p, i64], None),
        ("rx_feeder_create", [ctypes.c_int, i64, i64, ctypes.c_int], p),
        ("rx_feeder_read", [p, p, i64], i64),
        ("rx_feeder_overflows", [p], i64),
        ("rx_feeder_queued", [p], i64),
        ("rx_feeder_destroy", [p], None),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# codec wrappers (in/out numpy arrays; shapes like iq.formats)
# ---------------------------------------------------------------------------

def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _codec(name, x, in_dtype, out_dtype):
    lib = _load()
    x = np.ascontiguousarray(x, dtype=in_dtype)
    out = np.empty(x.shape[0], dtype=out_dtype)
    getattr(lib, name)(_ptr(x), _ptr(out), x.shape[0])
    return out


def cs16_to_cs8(x):
    return _codec("rx_cs16_to_cs8", x, np.int16, np.int8)


def cs16_to_cu8(x):
    return _codec("rx_cs16_to_cu8", x, np.int16, np.uint8)


def cs16_to_cf32(x):
    return _codec("rx_cs16_to_cf32", x, np.int16, np.float32)


def cs16_rescale8(x):
    return _codec("rx_cs16_rescale8", x, np.int16, np.int16)


def cu8_to_cs16(x):
    return _codec("rx_cu8_to_cs16", x, np.uint8, np.int16)


def cs8_to_cs16(x):
    return _codec("rx_cs8_to_cs16", x, np.int8, np.int16)


def cf32_to_cs16(x):
    return _codec("rx_cf32_to_cs16", x, np.float32, np.int16)


def cs12_to_cs16(raw):
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    triples = raw.shape[0] // 3
    out = np.empty(2 * triples, np.int16)
    lib.rx_cs12_to_cs16(_ptr(raw), _ptr(out), triples)
    return out


def cs16_to_cs12(x):
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.int16)
    pairs = x.shape[0] // 2
    out = np.empty(3 * pairs, np.uint8)
    lib.rx_cs16_to_cs12(_ptr(x), _ptr(out), pairs)
    return out


# ---------------------------------------------------------------------------
# feeder wrapper
# ---------------------------------------------------------------------------

class Feeder:
    """Bounded-queue block feeder over a file descriptor.

    ``drop_on_full=True`` gives realtime semantics (lagging consumer drops
    blocks, counted in :attr:`overflows`); ``False`` gives lossless
    backpressure for file replay.
    """

    def __init__(self, fd: int, block_bytes: int, depth: int = 8,
                 drop_on_full: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("librx_native.so not built")
        self._lib = lib
        self.block_bytes = int(block_bytes)
        self._h = lib.rx_feeder_create(fd, self.block_bytes, depth,
                                       1 if drop_on_full else 0)

    def read_block(self, timeout_ms: int = -1) -> np.ndarray | None:
        """One block of raw bytes; None on EOF.  Raises on timeout."""
        out = np.empty(self.block_bytes, np.uint8)
        n = self._lib.rx_feeder_read(self._h, _ptr(out), timeout_ms)
        if n == 0:
            return None
        if n < 0:
            raise TimeoutError("feeder read timed out")
        return out[:n]

    @property
    def overflows(self) -> int:
        return self._lib.rx_feeder_overflows(self._h)

    @property
    def queued(self) -> int:
        return self._lib.rx_feeder_queued(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rx_feeder_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
