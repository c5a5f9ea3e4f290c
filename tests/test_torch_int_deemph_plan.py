"""The arithmetic and the schedule of ``int_deemph.cu``, on the CPU.

The kernel divides by host-computed constants (``kernels/plan.py::
div_magic``) and walks each tile in segments whose starting carry is found
where walks from both ends of the block's range meet inside a halo
(``plan.deemph_plan``), with an ordered fallback where they do not.  Here
the constants are held to C's truncating division, the facts the schedule
rests on (one step is monotone with slope 0 or 1 and never overshoots) are
checked, and ``tests/oracles/deemph_schedule.py``, a model that follows the
kernel step for step, is held bit for bit to the plain walk and to the
reference package's ``lax.scan``.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import deemph_schedule as sched
from rx_tools_tpu.ops import intaudio as ref_int
from rx_tools_tpu_torch.kernels import build, plan
from rx_tools_tpu_torch.ops import intaudio
from rx_tools_tpu_torch.ops.filters import deemph_alpha

torch.set_num_threads(2)

AVG0 = [0, -1234, 40000, 70000, -(2 ** 31 + 5)]    # the last: 64-bit walk
A = [1, 2, 8, 13, 75, 240]
N = ["1", "L-1", "L", "L+1", "1368", "9000"]

_ref_scan = jax.jit(ref_int.deemph_int, static_argnums=2)


def _plain(avg0: int, x: np.ndarray, a: int):
    avg, y = intaudio.deemph_int_plain(torch.tensor(avg0, dtype=torch.int64),
                                       torch.as_tensor(x, dtype=torch.int64),
                                       a)
    return int(avg), y.numpy()


def _reference(avg0: int, x: np.ndarray, a: int):
    with jax.enable_x64(True):
        avg, y = _ref_scan(jnp.int64(avg0), jnp.asarray(x, jnp.int64), a)
        return int(avg), np.asarray(y)


def _cdiv(num: np.ndarray, a) -> np.ndarray:
    """C's truncating division, by torch (independent of the model)."""
    return intaudio._cdiv(torch.as_tensor(num),
                          torch.as_tensor(a, dtype=torch.int64)).numpy()


def _kernel_div(num: np.ndarray, a: int) -> np.ndarray:
    """The kernel's division: the magnitude by the constants, then the
    numerator's sign."""
    m, s = plan.div_magic(a)
    q = sched.divide(np.abs(num).astype(np.uint64), m, s).astype(np.int64)
    return np.where(num < 0, -q, q)


# ---- the division constants ------------------------------------------------

@pytest.mark.parametrize("a0", [1, 129, 257, 385])
def test_div_magic_exhaustive(a0):
    """Every a in 1..512 and every |num| <= 2**17 + a."""
    for a in range(a0, a0 + 128):
        num = np.arange(-(2 ** 17 + a), 2 ** 17 + a + 1, dtype=np.int64)
        np.testing.assert_array_equal(_kernel_div(num, a), _cdiv(num, a),
                                      err_msg=f"a = {a}")


@pytest.mark.parametrize("tc", [75, 50])
def test_div_magic_at_every_deemph_alpha(tc):
    """Every constant the CLIs can derive (-r from 1 kHz to 3.2 MHz in
    1 kHz steps, -c us / eu)."""
    alphas = sorted({deemph_alpha(r, tc) for r in range(1000, 3_200_001,
                                                        1000)})
    assert alphas[0] == 1 and len(alphas) > 100
    for a in alphas:
        num = np.arange(-(2 ** 17 + a), 2 ** 17 + a + 1, dtype=np.int64)
        np.testing.assert_array_equal(_kernel_div(num, a), _cdiv(num, a),
                                      err_msg=f"a = {a}")


def test_div_magic_random_wide():
    """10**5 numerators below 2**31 at random a below 2**31, the edges
    included."""
    rng = np.random.default_rng(31)
    a = rng.integers(1, 2 ** 31, 10 ** 5)
    num = rng.integers(-(2 ** 31) + 1, 2 ** 31, 10 ** 5)
    a[:6] = [1, 2 ** 31 - 1, 2 ** 30, 2 ** 30 + 1, 3, 2 ** 31 - 1]
    num[:6] = [2 ** 31 - 1, 2 ** 31 - 1, -(2 ** 31 - 1), 2 ** 31 - 2, 0, 1]
    want = _cdiv(num, a)
    got = np.empty_like(num)
    for i, (ai, ni) in enumerate(zip(a.tolist(), num.tolist())):
        got[i] = _kernel_div(np.array([ni]), ai)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a", [0, -3, 2 ** 31])
def test_div_magic_refuses_a_out_of_range(a):
    with pytest.raises(ValueError):
        plan.div_magic(a)


def test_div_magic_fits_32_bits():
    for a in [1, 2, 3, 13, 1000, 2 ** 20 + 7, 2 ** 30 + 1, 2 ** 31 - 1]:
        m, s = plan.div_magic(a)
        assert 2 ** 31 <= m < 2 ** 32 and 0 <= s <= 31


# ---- the facts the schedule rests on ----------------------------------------

def _step(c: np.ndarray, v: int, a: int) -> np.ndarray:
    """One exact step of the recurrence on int64 carries."""
    d = v - c
    h = a // 2
    return c + np.where(d > 0, (d + h) // a, -((h - d) // a))


@pytest.mark.parametrize("a", [1, 2, 13, 75, 199, 2 ** 20 + 7, 2 ** 31 - 1])
def test_step_has_slope_zero_or_one(a):
    """``d - q(d)`` never decreases and grows by at most 1 a unit of d."""
    d = np.arange(-200_000, 200_001, dtype=np.int64)
    g = d - _cdiv(np.where(d > 0, d + a // 2, d - a // 2), a)
    steps = np.diff(g)
    assert steps.min() >= 0 and steps.max() <= 1


@pytest.mark.parametrize("a", [1, 2, 13, 75])
@pytest.mark.parametrize("kind", ["noise", "tone", "square"])
def test_sandwich(a, kind):
    """Walks from every carry in [lo, hi] stay ordered, inside the hull of
    {avg} and the samples, and once two meet they stay together."""
    x = sched.signal(kind, 600, seed=a)
    avg = -40000
    lo, hi = min(avg, int(x.min())), max(avg, int(x.max()))
    c = np.unique(np.concatenate([
        [lo, hi, avg], np.random.default_rng(a).integers(lo, hi + 1, 400)]))
    for v in x.tolist():
        nxt = _step(c, v, a)
        assert np.all(np.diff(nxt) >= 0)                 # ordered
        assert np.all(np.diff(nxt) <= np.diff(c))        # slope 0 or 1
        assert nxt.min() >= lo and nxt.max() <= hi       # inside the hull
        assert np.all((nxt >= np.minimum(c, v)) & (nxt <= np.maximum(c, v)))
        c = nxt


# ---- the plan ---------------------------------------------------------------

def test_plan_matches_kernel_limits():
    text = (build.CSRC / "int_deemph.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kTile") == plan.DEEMPH_TILE
    assert plan.DEEMPH_MAX_SEGMENTS <= const("kThreads")


@pytest.mark.parametrize("n", [1, 11, 300, 1368, 4096, 4097, 9000])
@pytest.mark.parametrize("a", [1, 2, 13, 36, 40, 75, 240, 2 ** 31 - 1])
def test_plan_segments(n, a):
    p = plan.deemph_plan(n, a)
    tile = min(n, plan.DEEMPH_TILE)
    assert (p.magic, p.shift) == plan.div_magic(a)
    assert 1 <= p.segments(tile) <= plan.DEEMPH_MAX_SEGMENTS
    if p.halo:
        assert p.halo == plan.deemph_halo(a)
        assert 2 * (p.halo + p.seg_len) <= tile
    else:                                      # one segment: the serial walk
        assert p.seg_len == tile and p.segments(tile) == 1


def test_plan_segments_the_wbfm_block_up_to_a_37():
    """At 1368 samples the walk is segmented while the halo plus a segment
    is at most half the block: a <= 37 (wbfm's a = 13 among them)."""
    seg = [a for a in range(1, 241) if plan.deemph_plan(1368, a).halo]
    assert seg == list(range(1, 38))
    assert plan.deemph_halo(13) == math.ceil(1.6 * 13 * math.log(65536))


# ---- the schedule against the plain walk and the reference ----------------

def _n(label: str, a: int) -> int:
    seg_len = plan.deemph_plan(1368, a).seg_len
    return {"L-1": seg_len - 1, "L": seg_len, "L+1": seg_len + 1}.get(
        label, None) or int(label)


@pytest.mark.parametrize("n_label", N)
@pytest.mark.parametrize("a", A)
@pytest.mark.parametrize("kind", sched.KINDS)
def test_schedule_matches_plain_and_reference(kind, a, n_label):
    n = _n(n_label, a)
    x = sched.signal(kind, n, seed=n + a)
    for avg0 in AVG0:
        got_avg, got_y, _, _ = sched.walk(avg0, x, a)
        want_avg, want_y = _plain(avg0, x, a)
        ref_avg, ref_y = _reference(avg0, x, a)
        assert got_avg == want_avg == ref_avg, (avg0, got_avg, want_avg)
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(want_y, ref_y)


@pytest.mark.parametrize("seg_len,halo", [(16, 0), (16, 3), (17, 40),
                                          (50, 0), (33, 200), (4096, 0)])
@pytest.mark.parametrize("kind", ["noise", "tone", "step"])
def test_schedule_with_forced_segments(kind, seg_len, halo):
    """Short halos leave walks that meet inside their segment or not at
    all: the fallback walks exactly the samples before the meeting, over
    tiles too (9000 samples)."""
    for n in (300, 9000):
        x = sched.signal(kind, n, seed=seg_len + n)
        for avg0 in (0, 40000, -(2 ** 31 + 5)):
            got_avg, got_y, _, _ = sched.walk(avg0, x, 13, seg_len, halo)
            want_avg, want_y = _plain(avg0, x, 13)
            assert got_avg == want_avg
            np.testing.assert_array_equal(got_y, want_y)


def test_schedule_falls_back_only_where_walks_cannot_meet():
    """At wbfm's a = 13 on a 1368-sample block: noise and a tone meet in
    every halo; silence away from the average never meets and walks in
    order; a short halo meets inside segments (a partial fallback)."""
    n, a = 1368, 13
    p = plan.deemph_plan(n, a)
    for kind in ("noise", "tone", "square"):
        *_, segs, samples = sched.walk(40000, sched.signal(kind, n, 1), a)
        assert segs == samples == 0, kind
    silence = sched.signal("silence", n, 1)
    got_avg, got_y, segs, samples = sched.walk(40000, silence, a)
    exact = p.halo // p.seg_len + 1         # halos that reach sample 0
    assert segs == p.segments(n) - exact
    assert samples == n - exact * p.seg_len
    want_avg, want_y = _plain(40000, silence, a)
    assert got_avg == want_avg
    np.testing.assert_array_equal(got_y, want_y)
    noise = sched.signal("noise", n, 1)
    *_, segs, samples = sched.walk(40000, noise, a, 11, 60)
    assert 0 < samples < segs * 11


@pytest.mark.parametrize("above", [True, False])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("a", [1, 13, 2 ** 31 - 1])
def test_schedule_at_the_32_bit_limit(a, offset, above):
    """``hi - lo + a/2`` at 2**31 - 1 (the last range the 32-bit walk
    takes, its doubled numerator at 2**32 - 2) and at 2**31 (the first the
    64-bit walk takes), the first step as wide as the range: exact either
    way, and with short segments the narrow walk's fallback shows which
    walk ran."""
    avg0, x = sched.edge_case(a, offset, above)
    lo, hi = min(avg0, int(x.min())), max(avg0, int(x.max()))
    assert hi - lo + a // 2 == 2 ** 31 - 1 + offset
    assert sched.narrow(lo, hi, a) == (offset == 0)
    want_avg, want_y = _plain(avg0, x, a)
    ref_avg, ref_y = _reference(avg0, x, a)
    assert want_avg == ref_avg
    np.testing.assert_array_equal(want_y, ref_y)
    for schedule in ((), (16, 0)):
        got_avg, got_y, segs, _ = sched.walk(avg0, x, a, *schedule)
        assert got_avg == want_avg, schedule
        np.testing.assert_array_equal(got_y, want_y)
        if schedule and a > 1:      # at a = 1 every walk meets in one step
            assert (segs > 0) == (offset == 0)


def test_schedule_exact_at_int64_extremes():
    """The 64-bit walk is exact for any int64 pair (differences past
    2**63 included), like the plain walk's Python integers."""
    x = np.array([2 ** 62, -(2 ** 62), 2 ** 63 - 1, -(2 ** 63), 5, -7, 0],
                 np.int64)
    for avg0 in (-(2 ** 63), 2 ** 63 - 1, 0):
        for a in (1, 13, 2 ** 31 - 1):
            got_avg, got_y, _, _ = sched.walk(avg0, x, a)
            want_avg, want_y = _plain(avg0, x, a)
            assert got_avg == want_avg
            np.testing.assert_array_equal(got_y, want_y)
