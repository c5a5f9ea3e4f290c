"""Spectral window functions.

A numpy copy of :mod:`rx_tools_tpu.ops.windows`, tested bitwise equal.
The eight windows of rx_power (``src/rtl_power.c:322-401``), selected by
``-w`` (``rtl_power.c:881-898``).  Note reference quirks preserved on
purpose: ``kaiser`` is a stub equal to rectangle (``rtl_power.c:385-389``),
``youssef`` is a Blackman-Harris-Poisson hybrid, and ``hamming`` uses the
25/46 exact-coefficient form.  The reference quantizes to int ``×256``
(``rtl_power.c:1034-1037``); :func:`window_coefs_int` reproduces that for the
golden oracles, while the float path uses full precision.
"""

from __future__ import annotations

import numpy as np


def _n1(length: int) -> float:
    return float(length - 1)


def rectangle(i, length):
    return np.ones_like(np.asarray(i, dtype=np.float64))


def hamming(i, length):
    a, b = 25.0 / 46.0, 21.0 / 46.0
    return a - b * np.cos(2 * np.pi * i / _n1(length))


def blackman(i, length):
    a0, a1, a2 = 7938.0 / 18608.0, 9240.0 / 18608.0, 1430.0 / 18608.0
    x = 2 * np.pi * i / _n1(length)
    return a0 - a1 * np.cos(x) + a2 * np.cos(2 * x)


def blackman_harris(i, length):
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    x = 2 * np.pi * i / _n1(length)
    return a0 - a1 * np.cos(x) + a2 * np.cos(2 * x) - a3 * np.cos(3 * x)


def hann_poisson(i, length):
    a = 2.0
    n1 = _n1(length)
    i = np.asarray(i, dtype=np.float64)
    return (0.5 * (1 - np.cos(2 * np.pi * i / n1))
            * np.exp(-a * np.abs((n1 - 1 - 2 * i).astype(np.int64)) / n1))


def youssef(i, length):
    """Blackman-Harris-Poisson ("a mouthful", rtl_power.c:370-383)."""
    n1 = _n1(length)
    i = np.asarray(i, dtype=np.float64)
    w = blackman_harris(i, length)
    return w * np.exp(-0.0025 * np.abs((n1 - 1 - 2 * i).astype(np.int64)) / n1)


def kaiser(i, length):
    # reference stub: "todo, become more smart" (rtl_power.c:385-389)
    return np.ones_like(np.asarray(i, dtype=np.float64))


def bartlett(i, length):
    i = np.asarray(i, dtype=np.float64)
    w = np.abs((i - _n1(length) / 2) / (length / 2.0))
    return 1.0 - w


WINDOWS = {
    "rectangle": rectangle,
    "hamming": hamming,
    "blackman": blackman,
    "blackman-harris": blackman_harris,
    "hann-poisson": hann_poisson,
    "youssef": youssef,
    "kaiser": kaiser,
    "bartlett": bartlett,
}


def window(name: str, length: int, dtype=np.float32) -> np.ndarray:
    """Full-precision window vector (the float path)."""
    fn = WINDOWS[name]
    i = np.arange(length)
    return fn(i, length).astype(dtype)


def window_coefs_int(name: str, length: int) -> np.ndarray:
    """Reference-quantized coefficients: ``(int)(256 * w(i, N))``."""
    return np.trunc(256.0 * window(name, length, np.float64)).astype(np.int32)
