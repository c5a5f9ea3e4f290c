"""The port's WBFM tail ops against the reference package on the CPU:
discriminators, de-emphasis (both reference forms), the squelch RMS and
the rational resampler (both reference forms)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rx_tools_tpu.ops import discriminators as ref_disc
from rx_tools_tpu.ops import filters as ref_fl
from rx_tools_tpu.ops import resample as ref_rs
from rx_tools_tpu_torch.ops import discriminators, filters, resample

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.fixture
def planar():
    rng = np.random.default_rng(21)
    zi = (rng.standard_normal(1000) * 60).astype(np.float32)
    zq = (rng.standard_normal(1000) * 60).astype(np.float32)
    zi[17] = zq[17] = 0.0                    # a 0/0 sample
    zi[40:43] = 0.0                          # cr == 0 lanes
    return np.float32([3.0, -2.0]), zi, zq


@pytest.mark.parametrize("mode", [discriminators.DISC_FAST,
                                  discriminators.DISC_LUT,
                                  discriminators.DISC_ALE])
@pytest.mark.parametrize("stride", [None, 100])
def test_discriminators_bitwise(planar, mode, stride):
    """fast/lut/ale are elementwise rational/integer formulas: bit for bit
    for equal inputs; the std-atan2 seams within a few ulp
    (CLAUDE.md:107-114: atan2 is not stable in its last ulp)."""
    prev, zi, zq = planar
    pj, dj = ref_disc.fm_discriminate_planar(
        jnp.asarray(prev), jnp.asarray(zi), jnp.asarray(zq), mode,
        seam_stride=stride)
    pt, dt = discriminators.fm_discriminate_planar(_t(prev), _t(zi), _t(zq),
                                                   mode, seam_stride=stride)
    dj, dt = np.asarray(dj), dt.numpy()
    seams = np.zeros(dj.shape[0], bool)
    seams[::stride or dj.shape[0]] = True
    np.testing.assert_array_equal(dt[~seams], dj[~seams])
    assert _ulps(dt[seams], dj[seams]).max() <= 2
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_std_discriminator_within_ulps(planar):
    prev, zi, zq = planar
    _, dj = ref_disc.fm_discriminate_planar(
        jnp.asarray(prev), jnp.asarray(zi), jnp.asarray(zq),
        discriminators.DISC_STD)
    _, dt = discriminators.fm_discriminate_planar(
        _t(prev), _t(zi), _t(zq), discriminators.DISC_STD)
    dj, dt = np.asarray(dj), dt.numpy()
    same_sign = np.sign(dj) == np.sign(dt)
    assert same_sign.all()
    assert _ulps(dt, dj).max() <= 4


def test_lut_integer_inputs_and_table():
    np.testing.assert_array_equal(discriminators._atan_lut_host(),
                                  ref_disc._atan_lut_host())
    rng = np.random.default_rng(3)
    cr = rng.integers(-2 ** 21, 2 ** 21, 4000).astype(np.int32)
    cj = rng.integers(-2 ** 21, 2 ** 21, 4000).astype(np.int32)
    cr[:8] = [0, 0, 0, 5, -5, 1, 7, -7]
    cj[:8] = [0, 3, -3, 0, 0, 1, 1, 1]
    want = np.asarray(ref_disc.polar_disc_lut(jnp.asarray(cr),
                                              jnp.asarray(cj)))
    got = discriminators.polar_disc_lut(_t(cr), _t(cj)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fm_discriminate_interleaved(planar):
    prev, zi, zq = planar
    x = np.stack([zi, zq], -1)
    pj, dj = ref_disc.fm_discriminate(jnp.asarray(prev), jnp.asarray(x),
                                      discriminators.DISC_FAST)
    pt, dt = discriminators.fm_discriminate(_t(prev), _t(x),
                                            discriminators.DISC_FAST)
    np.testing.assert_array_equal(dt.numpy()[1:], np.asarray(dj)[1:])
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert discriminators.disc_mode("lut") == ref_disc.disc_mode("lut")


@pytest.fixture(params=[False, True], ids=["hillis_steele", "matmul"])
def deemph_form(request):
    """Both reference forms: the CPU blocked scan and the matmul scan
    (forced on both sides with the packages' test hooks)."""
    old = (ref_fl._MXU_FORCE, filters._MXU_FORCE)
    ref_fl._MXU_FORCE = filters._MXU_FORCE = request.param
    yield request.param
    ref_fl._MXU_FORCE, filters._MXU_FORCE = old


@pytest.mark.parametrize("n,a", [(5000, 7), (1368, 13), (700, 46)])
def test_deemph_matches_reference(deemph_form, n, a):
    # tolerance of tests/test_ops_demod.py::test_deemph_state_carry
    rng = np.random.default_rng(n + a)
    x = (rng.standard_normal(n) * 3000).astype(np.float32)
    aj, yj = ref_fl.deemph_filter(jnp.float32(1.5), jnp.asarray(x), a)
    at, yt = filters.deemph_filter(torch.tensor(1.5), _t(x), a)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-4, atol=1e-2)


def test_deemph_alpha_and_dc_block():
    for rate, tc in ((170000, 75), (32000, 75), (170000, 50), (171428, 75)):
        assert filters.deemph_alpha(rate, tc) == ref_fl.deemph_alpha(rate, tc)
    rng = np.random.default_rng(13)
    x = rng.integers(-3000, 5000, 128).astype(np.float32)
    aj, yj = ref_fl.dc_block_audio(jnp.float32(12.0), jnp.asarray(x))
    at, yt = filters.dc_block_audio(torch.tensor(12.0), _t(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def test_deemph_blocks_bitwise_equals_sequential():
    """deemph_blocks == M sequential deemph_filter calls bit for bit on the
    matmul path (the scan engine's batched tail depends on it)."""
    rng = np.random.default_rng(23)
    old = filters._MXU_FORCE
    filters._MXU_FORCE = True
    try:
        for m, k, a in ((5, 1536, 7), (3, 1280, 46), (4, 1000, 7)):
            x = rng.normal(0, 9000, (m, k)).astype(np.float32)
            avg0 = torch.tensor(np.float32(rng.normal() * 50))
            avg_s, ys = avg0, []
            for i in range(m):
                avg_s, y = filters.deemph_filter(avg_s, _t(x[i]), a)
                ys.append(y.numpy())
            avg_b, yb = filters.deemph_blocks(avg0, _t(x), a)
            np.testing.assert_array_equal(yb.numpy(), np.stack(ys))
            assert float(avg_b) == float(avg_s)
    finally:
        filters._MXU_FORCE = old


def test_rms_level_planar():
    rng = np.random.default_rng(14)
    zi = (rng.standard_normal(4104) * 40 + 3).astype(np.float32)
    zq = (rng.standard_normal(4104) * 40 - 1).astype(np.float32)
    want = float(ref_fl.rms_level_planar(jnp.asarray(zi), jnp.asarray(zq)))
    got = float(filters.rms_level_planar(_t(zi), _t(zq)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture(params=[False, True], ids=["cumsum", "rows"])
def rs_form(request):
    """Both reference forms of the resampler: cumsum (the CPU default) and
    the rows path (forced with the test hooks, tests/test_stream.py:106)."""
    old = (ref_rs._ROWS_FORCE, resample._ROWS_FORCE)
    ref_rs._ROWS_FORCE = resample._ROWS_FORCE = request.param
    yield request.param
    ref_rs._ROWS_FORCE, resample._ROWS_FORCE = old


@pytest.mark.parametrize("fast,slow,n", [
    (171428, 32000, 128 * 36),    # the wbfm 2.4M/14 -> 32k ratio
    (170000, 32000, 1368),        # the CLI block (n % 128 != 0: cumsum)
    (24000, 18000, 2560),         # ratio < 2
])
def test_resample_matches_reference(rs_form, fast, slow, n):
    """Emission counts and carried phase integer-exact; values at the
    tolerance of tests/test_resample_rows.py:27-40."""
    rng = np.random.default_rng(5)
    sj = ref_rs.ResampleState(jnp.float32(0.0), jnp.int32(0))
    st = resample.ResampleState.init("cpu")
    for i in range(2):                     # chained: nonzero phase + acc
        x = rng.normal(0, 1000, n).astype(np.float32)
        sj, yj, nj = ref_rs.resample_rational(sj, jnp.asarray(x), fast, slow)
        st, yt, nt = resample.resample_rational(st, _t(x), fast, slow)
        assert int(nt) == int(nj)
        assert int(st.phase) == int(sj.phase)
        assert st.phase.dtype == torch.int32 and yt.shape == yj.shape
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-2,
                                   err_msg=f"chunk {i}")
        assert (abs(float(st.acc) - float(sj.acc))
                < 2e-2 + 1e-4 * abs(float(sj.acc)))


def test_resample_phase_guard_and_direction():
    st = resample.ResampleState.init("cpu")
    with pytest.raises(ValueError):
        resample.resample_rational(st, torch.zeros(300000), 170001, 32000)
    with pytest.raises(ValueError):
        resample.resample_rational(st, torch.zeros(100), 32000, 48000)


def test_rows_blocks_bitwise_equals_sequential():
    """resample_rows_blocks == M sequential _resample_rows calls bit for bit
    (outputs, counts, carried acc/phase)."""
    rng = np.random.default_rng(17)
    for fast, slow, n, m in ((42857, 8000, 1536, 5), (85, 16, 1280, 7),
                             (75, 64, 2048, 3), (3, 1, 896, 4)):
        x = rng.normal(0, 3000, (m, n)).astype(np.float32)
        st0 = resample.ResampleState(torch.tensor(np.float32(7.5)),
                                     torch.tensor(11 % fast,
                                                  dtype=torch.int32))
        st, ys, nvs = st0, [], []
        for i in range(m):
            st, y, nv = resample._resample_rows(st, _t(x[i]), fast, slow)
            ys.append(y.numpy())
            nvs.append(int(nv))
        sb, yb, nvb = resample.resample_rows_blocks(st0, _t(x), fast, slow)
        np.testing.assert_array_equal(yb.numpy(), np.stack(ys))
        np.testing.assert_array_equal(nvb.numpy(), np.array(nvs))
        assert float(sb.acc) == float(st.acc)
        assert int(sb.phase) == int(st.phase)
        assert math.gcd(fast, slow) == 1
