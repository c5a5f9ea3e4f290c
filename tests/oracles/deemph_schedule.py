"""A model of ``int_deemph.cu``'s schedule in NumPy and Python integers.

The kernel computes the integer de-emphasis (rtl_fm.c:667-682)::

    d = x[i] - c;  c += (d > 0 ? d + a/2 : d - a/2) / a    (C division)

as a segmented walk (see the kernel's source comment).  This model follows
its steps one for one, so the CPU tests hold the schedule itself to the
plain walk: the block's range ``[lo, hi]``, the 32-bit low-word arithmetic
with the plan's division constants when the range allows it, the 64-bit
walk when it does not, each tile's segments walked in lockstep (one lane a
segment, as the kernel's threads) from both ends of the range through
their halos, the count of each segment's leading samples whose walks had
not met, and the ordered fallback that walks those samples from the exact
carry.

Nothing here imports JAX, so the card tests can use it too.
"""

from __future__ import annotations

import numpy as np

from rx_tools_tpu_torch.kernels import plan

_M32 = np.uint64(0xFFFFFFFF)

#: the input classes of the tests (see :func:`signal`)
KINDS = ["noise", "tone", "silence", "constant", "square", "step"]


def signal(kind: str, n: int, seed: int) -> np.ndarray:
    """``n`` int64 samples of one input class, made from ``seed``: uniform
    int16 noise, a 1 kHz tone at 170 kHz with noise, silence, a constant,
    a full-scale square wave, a step from 0 to 20000."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "noise":
        return rng.integers(-32768, 32768, n)
    if kind == "tone":
        tone = 20000 * np.sin(2 * np.pi * 1000 * t / 170000)
        return np.clip(np.round(tone + rng.normal(0, 2000, n)), -32768,
                       32767).astype(np.int64)
    if kind == "silence":
        return np.zeros(n, np.int64)
    if kind == "constant":
        return np.full(n, 12345, np.int64)
    if kind == "square":                       # period 74
        return np.where((t // 37) % 2 == 0, -32768, 32767).astype(np.int64)
    if kind == "step":
        return np.where(t < n // 2, 0, 20000).astype(np.int64)
    raise ValueError(kind)


def narrow(lo: int, hi: int, a: int) -> bool:
    """Whether the kernel walks on low 32-bit words: while ``hi - lo +
    a/2 < 2**31`` every difference and doubled numerator fits 32 bits."""
    return hi - lo + a // 2 < 2 ** 31


def edge_case(a: int, offset: int, above: bool, n: int = 1368,
              seed: int = 0) -> tuple[int, np.ndarray]:
    """``(avg, x)``: int16 noise and an average with ``hi - lo + a/2 ==
    2**31 - 1 + offset``, the average above the samples or below them, and
    the first sample at the far end of the range, so the first step's
    difference is the widest the range allows."""
    x = signal("noise", n, seed)
    far = -32768 if above else 32767
    x[0] = far
    span = 2 ** 31 - 1 + offset - a // 2
    return (far + span if above else far - span), x


def divide(num_abs, magic: int, shift: int):
    """The kernel's division of magnitudes ``num_abs < 2**31`` (uint64
    array): ``umulhi(2 * n, m) >> s``."""
    n2 = np.asarray(num_abs, np.uint64) * np.uint64(2)
    return ((n2 * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)


def step32(c, v, h2: int, magic: int, shift: int):
    """One step of the 32-bit walk on low words (uint64 arrays holding
    uint32 values), exactly as the kernel's ``step32``."""
    d = ((v - c) & _M32).astype(np.uint32).view(np.int32).astype(np.int64)
    pos = d > 0
    n2 = (2 * np.abs(d) + h2).astype(np.uint64) & _M32
    q = ((n2 * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
    return np.where(pos, c + q, c - q) & _M32


def _step32_int(c: int, v: int, h2: int, magic: int, shift: int) -> int:
    """:func:`step32` on one lane, in Python integers."""
    d = (v - c) & 0xFFFFFFFF
    d = d - (1 << 32) if d >= 1 << 31 else d
    n2 = (2 * abs(d) + h2) & 0xFFFFFFFF
    q = ((n2 * magic) >> 32) >> shift
    return (c + q if d > 0 else c - q) & 0xFFFFFFFF


def _step_wide(c: int, v: int, a: int, magic: int, shift: int) -> int:
    """One step of the 64-bit walk: the magnitude of the difference, the
    constants' division below 2**31, C's division above."""
    h = a // 2
    m = abs(v - c)
    if m + h < 2 ** 31:
        q = int(divide(m + h, magic, shift))
    else:
        q = m // a + (m % a + h) // a
    return c + q if v > c else c - q


def _i16(v):
    return ((np.asarray(v, np.int64) & 0xFFFF) ^ 0x8000) - 0x8000


def walk(avg: int, x, a: int, seg_len: int | None = None,
         halo: int | None = None, tile: int = plan.DEEMPH_TILE):
    """``(avg, y, fallback_segments, fallback_samples)`` of the kernel on
    ``x`` from ``avg`` at ``a``, with ``plan.deemph_plan``'s segments unless
    ``seg_len`` and ``halo`` are given."""
    with np.errstate(over="ignore"):       # uint32 walks wrap, as on the card
        return _walk(avg, np.asarray(x, np.int64), int(a), seg_len, halo,
                     tile)


def _walk(avg, x, a, seg_len, halo, tile):
    avg, n = int(avg), x.size
    p = plan.deemph_plan(n, a)
    seg_len = p.seg_len if seg_len is None else int(seg_len)
    halo = p.halo if halo is None else int(halo)
    lo = min([avg] + ([int(x.min())] if n else []))
    hi = max([avg] + ([int(x.max())] if n else []))
    h = a // 2
    if not narrow(lo, hi, a):               # the 64-bit walk, serial
        c, y = avg, []
        for v in x.tolist():
            c = _step_wide(c, v, a, p.magic, p.shift)
            y.append(c)
        return c, _i16(np.array(y, np.int64)), 0, 0

    lo32, hi32 = np.uint64(lo & 0xFFFFFFFF), np.uint64(hi & 0xFFFFFFFF)
    xl = (x.astype(np.uint64)) & _M32
    h2 = 2 * h
    carry = np.uint64(avg & 0xFFFFFFFF)
    y = np.zeros(n, np.uint64)
    fb_segments = fb_samples = 0
    for base in range(0, n, tile):
        length = min(tile, n - base)
        xt = xl[base:base + length]
        s_count = -(-length // seg_len)
        if s_count == 1:        # one lane from the exact carry: never open
            c = int(carry)
            for i, v in enumerate(xt.tolist()):
                c = _step32_int(c, v, h2, p.magic, p.shift)
                y[base + i] = c
            carry = np.uint64(c)
            continue
        seg0 = np.arange(s_count, dtype=np.int64) * seg_len
        seg1 = np.minimum(seg0 + seg_len, length)
        hs = np.maximum(seg0 - halo, 0)
        exact = hs == 0
        cl = np.where(exact, carry, lo32).astype(np.uint64)
        ch = np.where(exact, carry, hi32).astype(np.uint64)
        open_ = np.zeros(s_count, np.int64)
        yt = np.zeros(length, np.uint64)
        for t in range(int((seg1 - hs).max())):      # phase A, lockstep
            i = hs + t
            act = i < seg1
            v = xt[np.minimum(i, length - 1)]
            cl = np.where(act, step32(cl, v, h2, p.magic, p.shift), cl)
            ch = np.where(act, step32(ch, v, h2, p.magic, p.shift), ch)
            ins = act & (i >= seg0)
            yt[i[ins]] = cl[ins]
            open_ += ins & (cl != ch)
        exits = cl.copy()
        for s in np.flatnonzero(open_).tolist():     # phase B, in order
            c = int(carry if s == 0 else exits[s - 1])
            for i in range(int(seg0[s]), int(seg0[s] + open_[s])):
                c = _step32_int(c, int(xt[i]), h2, p.magic, p.shift)
                yt[i] = c
            if open_[s] == seg1[s] - seg0[s]:
                exits[s] = c
            fb_segments += 1
            fb_samples += int(open_[s])
        y[base:base + length] = yt
        carry = exits[-1]
    avg_out = lo + int((int(carry) - int(lo32)) & 0xFFFFFFFF)
    return (avg_out, _i16(y.astype(np.int64)), fb_segments, fb_samples)
