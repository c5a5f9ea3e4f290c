"""The CUDA kernels' tile plans (``rx_tools_tpu_torch/kernels/plan.py``)
and the build's staleness check, on the CPU.

The kernels compute their tiles and CTA runs with the same formulas as
the planner, so checking the planner here checks what each launch covers:
every output sample exactly once, fused tiles inside one block, rings that
fit the H100's shared memory, and tiles that depend on D alone.
"""

import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from rx_tools_tpu_torch.kernels import build, plan
from rx_tools_tpu_torch.ops import frontend_mxu, fused_frontend

DS = [1, 6, 14, 126, 200, 500, 1800]
KS = [1, 33, 1001, 18432, 221184]
#: (SMs, resident CTAs per SM) of the grids the tests walk: the wrappers
#: take both from the card (the SM count and the CUDA occupancy calculator)
WAVES = [(1, 1), (7, 3), (132, 8), (132, 28)]
MAX_D = {"capture_head": frontend_mxu._MAX_D,
         "fused_capture_fm": fused_frontend._MAX_D}


def _covered(starts, counts, total):
    """The tiles, in CTA-run order, tile [0, total) with no gap or
    overlap."""
    starts = np.asarray(starts, np.int64)
    counts = np.asarray(counts, np.int64)
    assert counts.min() >= 1
    assert starts[0] == 0
    assert np.array_equal(starts[1:], starts[:-1] + counts[:-1])
    assert starts[-1] + counts[-1] == total


def _runs(n_tiles, n_ctas):
    bounds = [plan.run(c, n_tiles, n_ctas) for c in range(n_ctas)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n_tiles
    for (_, e), (b, _) in zip(bounds, bounds[1:]):
        assert e == b
    lens = [e - b for b, e in bounds]
    assert max(lens) - min(lens) <= 1 and min(lens) >= 1
    return bounds


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
def test_head_covers_every_output_once(d, k):
    p = plan.plan("capture_head", d)
    n_tiles = plan.head_tiles(p, k)
    t = np.arange(n_tiles)
    starts = t * p.rows
    counts = np.minimum(p.rows, k - starts)
    for sms, per_sm in WAVES:
        runs = _runs(n_tiles, plan.grid(n_tiles, sms, per_sm))
        order = np.concatenate([np.arange(b, e) for b, e in runs])
        _covered(starts[order], counts[order], k)


@pytest.mark.parametrize("m", [1, 2, 12, 48])
@pytest.mark.parametrize("d", [d for d in DS if d <= fused_frontend._MAX_D])
def test_fused_tiles_cover_once_inside_blocks(d, m):
    p = plan.plan("fused_capture_fm", d)
    for kpb in KS:
        tpb = plan.fused_tiles_per_block(p, kpb)
        n_tiles = m * tpb
        tiles = np.array([plan.fused_tile(p, t, kpb)
                          for t in (0, tpb - 1, n_tiles - 1)])
        t = np.arange(n_tiles)
        blk, local = np.divmod(t, tpb)
        starts = blk * kpb + local * p.rows
        counts = np.minimum(p.rows, kpb - local * p.rows)
        assert np.array_equal(tiles[:, 0], starts[[0, tpb - 1, -1]])
        assert np.array_equal(tiles[:, 1], counts[[0, tpb - 1, -1]])
        # never straddles a block
        assert np.array_equal(starts // kpb, (starts + counts - 1) // kpb)
        for sms, per_sm in WAVES:
            runs = _runs(n_tiles, plan.grid(n_tiles, sms, per_sm))
            order = np.concatenate([np.arange(b, e) for b, e in runs])
            _covered(starts[order], counts[order], m * kpb)


@pytest.mark.parametrize("kernel", sorted(MAX_D))
@pytest.mark.parametrize("d", DS)
def test_ring_fits_shared_memory(kernel, d):
    """Up to the kernel's largest D a plan exists; any plan it gives
    keeps its ring, with room for a 4-byte-misaligned tile, in 227 KB."""
    try:
        p = plan.plan(kernel, d)
    except ValueError:
        assert d > MAX_D[kernel]
        return
    assert 2 <= p.stages <= plan.MAX_STAGES
    assert p.stage_bytes % 16 == 0
    # the 16-byte superset of a 4-byte-aligned tile fits one stage
    tile = (p.rows + plan.HALO_ROWS[kernel]) * 4 * d
    assert max(((off + tile + 15) // 16) * 16 for off in (0, 4, 8, 12)) \
        <= p.stage_bytes
    assert p.smem + plan.STATIC_BYTES[kernel] <= 227 * 1024
    assert p.threads % 32 == 0 and p.rows <= p.threads <= plan.MAX_THREADS


@pytest.mark.parametrize("kernel", sorted(MAX_D))
def test_ring_fits_at_max_d(kernel):
    p = plan.plan(kernel, MAX_D[kernel])
    assert p.smem + plan.STATIC_BYTES[kernel] <= 227 * 1024
    if kernel == "fused_capture_fm":
        assert p.rows == p.threads >= 32


def _walk(p, kernel, k, m, n_ctas):
    """What the kernel computes under a grid of ``n_ctas``: for every tile
    of every CTA's run, in the order the CTAs walk them, its first output
    sample, its length and the slot of its level partial.  The fused
    kernel advances a (block, tile-in-block) cursor from its run's first
    tile (``fused_capture_fm.cu``); the head counts tiles from it."""
    kpb = k // m
    if kernel == "capture_head":
        n_tiles = plan.head_tiles(p, k)
    else:
        tpb = plan.fused_tiles_per_block(p, kpb)
        n_tiles = m * tpb
    out = []
    for cta in range(n_ctas):
        t0, t1 = plan.run(cta, n_tiles, n_ctas)
        if kernel == "capture_head":
            out += [(t * p.rows, min(p.rows, k - t * p.rows), None)
                    for t in range(t0, t1)]
            continue
        blk, loc = divmod(t0, tpb)
        for _ in range(t1 - t0):
            out.append((blk * kpb + loc * p.rows,
                        min(p.rows, kpb - loc * p.rows), blk * tpb + loc))
            loc += 1
            if loc == tpb:
                blk, loc = blk + 1, 0
    return n_tiles, out


@pytest.mark.parametrize("kernel,d", [(k, d) for k in sorted(MAX_D)
                                      for d in DS if d <= MAX_D[k]])
def test_tile_depends_on_d_alone(kernel, d):
    """Two cards' waves (7 SMs x 3 CTAs and 132 x 8) walk the same tiles,
    and the fused kernel's cursor puts each tile's level partial in the
    slot of its tile index, so the last CTA sums every block's partials
    in the same order on both."""
    p = plan.plan(kernel, d)
    m, k = 12, 221184
    n_tiles = plan.head_tiles(p, k) if kernel == "capture_head" else (
        m * plan.fused_tiles_per_block(p, k // m))
    grids = [plan.grid(n_tiles, sms, per_sm)
             for sms, per_sm in ((7, 3), (132, 8))]
    assert grids[0] < grids[1] <= n_tiles
    walks = [_walk(p, kernel, k, m, g)[1] for g in grids]
    assert walks[0] == walks[1] and len(walks[0]) == n_tiles
    if kernel == "fused_capture_fm":
        assert [w[2] for w in walks[0]] == list(range(n_tiles))
        assert all(w[:2] == plan.fused_tile(p, w[2], k // m)
                   for w in walks[0])


@pytest.mark.parametrize("kernel", sorted(MAX_D))
def test_kernel_limits_match_planner(kernel):
    text = (build.CSRC / f"{kernel}.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kMaxStages") == plan.MAX_STAGES
    assert const("kMaxThreads") == plan.MAX_THREADS
    assert '#include "head.cuh"' in text and '#include "ring.cuh"' in text


@pytest.mark.parametrize("d", [873, 1800, 5000])
def test_fused_refuses_partial_warps_and_big_tiles(d):
    """Past D = 872 a ring of two stages holds fewer than 32 rows of the
    fused kernel's tiles: no whole warp, so no plan."""
    with pytest.raises(ValueError, match="whole warps"):
        plan.plan("fused_capture_fm", d)


@pytest.mark.parametrize("d", [29045, 100000])
def test_head_refuses_d_past_its_ring(d):
    """Past D = 29044 two stages of one row each exceed 227 KB."""
    assert plan.plan("capture_head", 29044).rows == 1
    with pytest.raises(ValueError, match="no tile plan fits"):
        plan.plan("capture_head", d)


@pytest.mark.parametrize("n_tiles,sms,per_sm,want", [
    (864, 132, 4, 528), (3456, 132, 28, 3456), (5, 132, 8, 5), (0, 7, 3, 1)])
def test_grid_is_one_wave_capped_at_tiles(n_tiles, sms, per_sm, want):
    assert plan.grid(n_tiles, sms, per_sm) == want


def test_header_edit_makes_libraries_stale(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    out = tmp_path / "build"
    out.mkdir()
    for name in build.SOURCES:
        lib = out / f"lib{name}.so"
        lib.write_bytes(b"")
        later = max(f.stat().st_mtime for f in csrc.iterdir()) + 10
        os.utime(lib, (later, later))
        assert not build._stale(name, csrc, out)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["head.cuh", "ring.cuh"]
    for header in headers:
        edit = max((out / f"lib{n}.so").stat().st_mtime
                   for n in build.SOURCES) + 10
        os.utime(header, (edit, edit))
        for name in build.SOURCES:
            assert build._stale(name, csrc, out), (header.name, name)
            lib = out / f"lib{name}.so"
            os.utime(lib, (edit + 10, edit + 10))
        for name in build.SOURCES:
            assert not build._stale(name, csrc, out)
    assert build._stale("capture_head", csrc, Path(tmp_path / "missing"))
