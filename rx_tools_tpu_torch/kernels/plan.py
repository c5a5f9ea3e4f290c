"""Plans of the CUDA kernels: the head's and the fused front's tiles,
which depend on D alone, and the integer de-emphasis's division constants
and segments, which depend on its constant ``a`` and the block length.

Both kernels (``csrc/capture_head.cu``, ``csrc/fused_capture_fm.cu``) run
persistent CTAs, each walking a contiguous run of fixed-size tiles of
output samples.  One thread of the CTA keeps a ring of shared-memory
stages filled with 1-D bulk copies of each tile's input (the int16 pairs
of ``rows`` output samples, ``4 * D`` bytes each) while the other threads
compute the tiles that have arrived.

The plan fixes the tile (``rows`` output samples), the ring depth
(``stages``) and the bytes of one stage from D and the kernel alone.  The
SM count only sets how many CTAs share the tiles (:func:`grid`), so the
work of every tile, and the fixed-order sums that the fused kernel forms
per tile, are the same on every card and at every grid size.  This module
is plain Python: the CPU tests check the plans, and the wrappers pass them
to the C entry points.
"""

from __future__ import annotations

import dataclasses
import functools
import math

#: shared memory one CTA may use on the H100 (227 KB, as opt-in dynamic
#: shared memory above 48 KB)
SMEM_PER_CTA = 232_448

#: a CTA has at most this many threads, one output sample of a tile each
MAX_THREADS = 256
#: the ring holds at most this many stages
MAX_STAGES = 4
#: output samples per tile before D forces fewer.  The head's tiles are
#: small, so that a config #1 chunk's tiles all fit in one resident wave of
#: CTAs; the fused kernel's are large, so that the last CTA's in-order sum
#: over each block's tile partials stays short
TILE_ROWS = {"capture_head": 64, "fused_capture_fm": 256}
#: ring depth: double buffering.  At the main path's sizes a CTA walks one
#: or two tiles, and deeper rings only cost resident CTAs (PERF.md)
STAGES = 2

#: extra input rows a stage holds beside its tile: the fused kernel's
#: first tile of a run also brings the row of the sample before it
HALO_ROWS = {"capture_head": 0, "fused_capture_fm": 1}

#: static shared memory of each kernel beside its ring: the stage
#: barriers; the fused kernel adds its z tile, warp partials and flags
STATIC_BYTES = {"capture_head": 2 * 8 * MAX_STAGES,
                "fused_capture_fm": 8 * MAX_STAGES + 2 * 4 * MAX_THREADS
                + 2 * 4 * (MAX_THREADS // 32) + 16}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def stage_bytes(rows: int, d: int) -> int:
    """Bytes of one ring stage holding ``rows`` input rows: the
    16-byte-aligned superset of their bytes, which starts at most 12 bytes
    before them (a 4-byte-aligned view) and ends at most 12 bytes after."""
    return _align16(rows * 4 * d) + 16


@dataclasses.dataclass(frozen=True)
class TilePlan:
    kernel: str
    d: int
    rows: int           # output samples per tile (one thread each)
    stages: int         # depth of the shared-memory ring
    stage_bytes: int    # bytes of one stage (a multiple of 16)

    @property
    def threads(self) -> int:
        """Threads per CTA: one a row, at least a warp."""
        return max(32, (self.rows + 31) // 32 * 32)

    @property
    def smem(self) -> int:
        """Dynamic shared memory of one CTA: the ring."""
        return self.stages * self.stage_bytes


@functools.lru_cache(maxsize=None)
def plan(kernel: str, d: int) -> TilePlan:
    """The tile plan of ``kernel`` ("capture_head" or "fused_capture_fm")
    at decimation ``d``: tiles of the largest power of two of rows up to
    :data:`TILE_ROWS` whose ring of :data:`STAGES` stages fits in one CTA's
    shared memory.  Raises when none fits the kernel."""
    if kernel not in STATIC_BYTES:
        raise ValueError(f"unknown kernel {kernel!r}")
    d = int(d)
    if d < 1:
        raise ValueError(f"downsample {d} < 1")
    budget = SMEM_PER_CTA - STATIC_BYTES[kernel]
    rows = TILE_ROWS[kernel]
    while rows > 1 and STAGES * stage_bytes(rows + HALO_ROWS[kernel],
                                            d) > budget:
        rows //= 2
    p = TilePlan(kernel, d, rows, STAGES,
                 stage_bytes(rows + HALO_ROWS[kernel], d))
    if p.smem > budget:
        raise ValueError(f"{kernel}: no tile plan fits D={d} "
                         f"({p.smem} B of shared memory)")
    if kernel == "fused_capture_fm" and p.rows % 32:
        # the fused kernel sums its level partials by whole warps
        raise ValueError(f"fused_capture_fm: D={d} leaves tiles of "
                         f"{p.rows} rows, not whole warps")
    return p


def grid(n_tiles: int, sms: int, ctas_per_sm: int) -> int:
    """CTAs to launch: one resident wave of ``ctas_per_sm`` CTAs on each
    of ``sms`` SMs (the wrappers ask the CUDA occupancy calculator, which
    counts registers too), and never more than tiles."""
    return max(1, min(int(n_tiles), int(sms) * int(ctas_per_sm)))


def run(cta: int, n_tiles: int, n_ctas: int) -> tuple[int, int]:
    """Tiles ``[begin, end)`` of CTA ``cta``: contiguous runs whose lengths
    differ by at most one (the kernels compute the same split)."""
    return cta * n_tiles // n_ctas, (cta + 1) * n_tiles // n_ctas


def head_tiles(p: TilePlan, k_total: int) -> int:
    """Tiles of the capture head over ``k_total`` output samples; tile t
    covers ``[t * rows, min(k_total, (t + 1) * rows))``."""
    return -(-int(k_total) // p.rows)


def fused_tiles_per_block(p: TilePlan, k_per_block: int) -> int:
    """Tiles of one block in the fused kernel: tiles never straddle a
    block, so each block's level sums its own tiles' partials."""
    return -(-int(k_per_block) // p.rows)


def fused_tile(p: TilePlan, t: int, k_per_block: int) -> tuple[int, int]:
    """Output samples ``[k0, k0 + n)`` of fused tile ``t``."""
    tpb = fused_tiles_per_block(p, k_per_block)
    blk, local = divmod(t, tpb)
    local0 = local * p.rows
    return blk * int(k_per_block) + local0, min(p.rows,
                                                int(k_per_block) - local0)


# ---- int_deemph.cu ----------------------------------------------------------

#: samples one tile of ``int_deemph.cu`` stages in shared memory (its kTile)
DEEMPH_TILE = 4096
#: most segments a tile is cut into: one walking thread each, four warps
DEEMPH_MAX_SEGMENTS = 128
#: the halo covers this many times the steps in which the walks from the
#: ends of the int16 range typically meet (about a * ln 65536)
DEEMPH_HALO_MARGIN = 1.6


@functools.lru_cache(maxsize=None)
def div_magic(a: int) -> tuple[int, int]:
    """``(m, s)`` with ``floor(n / a) == umulhi(2 * n, m) >> s`` for every
    ``0 <= n < 2**31`` and ``0 < a < 2**31`` (Granlund and Montgomery,
    Theorem 4.2, with N = 31): ``s = ceil(log2 a)`` and ``m = ceil(2**(31 +
    s) / a)``, which is below ``2**32``.  ``umulhi`` is the high 32 bits of
    the 64-bit product; ``2 * n`` fits 32 bits because ``n < 2**31``."""
    a = int(a)
    if not 0 < a < 2 ** 31:
        raise ValueError(f"deemph_a {a} not in 1 .. 2**31 - 1")
    s = (a - 1).bit_length()
    return -(-(1 << (31 + s)) // a), s


@dataclasses.dataclass(frozen=True)
class DeemphPlan:
    magic: int          # m of :func:`div_magic`
    shift: int          # s of :func:`div_magic`
    seg_len: int        # samples of a segment (L)
    halo: int           # samples walked before a segment (W)

    def segments(self, n: int) -> int:
        """Segments of a tile of ``n`` samples (the kernel cuts each tile
        the same way)."""
        return -(-int(n) // self.seg_len)


def deemph_halo(a: int) -> int:
    """Halo of the segmented walk at ``a``: the walks from the two ends of
    the int16 range meet after about ``a * ln 65536`` samples of audio,
    with margin.  A halo that does not meet only sends its segment to the
    ordered fallback, so exactness never rests on it."""
    return math.ceil(DEEMPH_HALO_MARGIN * int(a) * math.log(65536))


@functools.lru_cache(maxsize=None)
def deemph_plan(n: int, a: int) -> DeemphPlan:
    """The plan of ``int_deemph.cu`` for blocks of ``n`` samples at ``a``:
    tiles of up to :data:`DEEMPH_TILE` samples cut into at most
    :data:`DEEMPH_MAX_SEGMENTS` segments of ``seg_len`` samples, each with
    a halo of :func:`deemph_halo` samples.  A segment's walk is about halo
    + seg_len steps against a tile's steps for one serial walk, so where
    that is not at most half the tile the plan is one segment: the serial
    walk."""
    magic, shift = div_magic(a)
    tile = max(1, min(int(n), DEEMPH_TILE))
    halo = deemph_halo(a)
    seg_len = -(-tile // DEEMPH_MAX_SEGMENTS)
    if 2 * (halo + seg_len) > tile:
        seg_len, halo = tile, 0
    return DeemphPlan(magic, shift, seg_len, halo)
