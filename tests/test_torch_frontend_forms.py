"""The reference's matrix forms of the capture head, its squelch estimators
and its exact-ratio resampler, in the port against the reference package
on the CPU, at the reference tests' own geometries and bounds
(tests/test_frontend_mxu.py, tests/test_ops_demod.py:220-259)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracles import c_ref
from rx_tools_tpu.ops import filters as ref_fl
from rx_tools_tpu.ops import frontend_mxu as ref_mxu
from rx_tools_tpu.ops import resample as ref_rs
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.ops import frontend_mxu

torch.set_num_threads(2)

# tests/test_frontend_mxu.py:29 (f32 sum reassociation class)
MM_TOL = dict(rtol=2e-5, atol=5e-3)
FLOAT_FORMS = ("capture_frontend_mm", "capture_frontend_t2",
               "capture_frontend_conv")
EXACT_FORMS = ("capture_frontend_mm_i8", "capture_frontend_mm_i16",
               "capture_frontend_mm_i16_2")
P_FORMS = ("capture_frontend_mm", "capture_frontend_mm_bf16") + EXACT_FORMS


def _blk(rng, d, k, lo=-32000, hi=32000):
    return rng.integers(lo, hi, 2 * d * k).astype(np.int16)


def _full_range(rng, d, k):
    """int16 over all of -32768 ... 32767, both ends present."""
    blk = rng.integers(-32768, 32768, 2 * d * k).astype(np.int16)
    blk[:4] = [-32768, 32767, -32768, 32767]
    return blk


def _port(name, blk, d, rot, **kw):
    zi, zq = getattr(frontend_mxu, name)(torch.from_numpy(blk), d, rot, **kw)
    assert zi.dtype == zq.dtype == torch.float32
    return zi.numpy(), zq.numpy()


def _ref(name, blk, d, rot, **kw):
    zi, zq = getattr(ref_mxu, name)(jnp.asarray(blk), d, rot, **kw)
    return np.asarray(zi), np.asarray(zq)


def _plain(blk, d, rot):
    zi, zq = frontend_mxu.capture_head_plain(torch.from_numpy(blk), d, rot)
    return zi.numpy(), zq.numpy()


@pytest.mark.parametrize("name", FLOAT_FORMS)
@pytest.mark.parametrize("d", [14, 4, 8, 5, 7])
@pytest.mark.parametrize("rotate", [True, False])
def test_float_forms_match_reference(name, d, rotate):
    # tests/test_frontend_mxu.py:21-47: K = 288 = 32 * 9
    rng = np.random.default_rng(d + rotate)
    blk = _blk(rng, d, 32 * 9)
    got = _port(name, blk, d, rotate)
    for want in (_ref(name, blk, d, rotate), _plain(blk, d, rotate)):
        assert got[0].shape == want[0].shape == (288,)
        np.testing.assert_allclose(got[0], want[0], **MM_TOL)
        np.testing.assert_allclose(got[1], want[1], **MM_TOL)


@pytest.mark.parametrize("name", P_FORMS)
def test_odd_k_falls_back_to_the_plain_head(name):
    # tests/test_frontend_mxu.py:50-59: K = 33 has no phase block; the
    # reference falls back to its f32 masked reduce, not integer-exact
    rng = np.random.default_rng(5)
    d = 14
    blk = _blk(rng, d, 33)
    assert frontend_mxu._pick_p(33, d, True) == 1
    got = _port(name, blk, d, True)
    plain = _plain(blk, d, True)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    want = _ref("capture_frontend_mm", blk, d, True)
    np.testing.assert_allclose(got[0], want[0], **MM_TOL)
    np.testing.assert_allclose(got[1], want[1], **MM_TOL)


@pytest.mark.parametrize("name", EXACT_FORMS)
@pytest.mark.parametrize("d,k,rot", [
    (14, 32 * 24, True),     # tests/test_frontend_mxu.py:138-153, P = 32
    (14, 32 * 3, True),      # 3 rows: fewer than torch._int_mm's 17
    (5, 2 * 49, False),      # P = 2: 4 columns, contraction 20
    (6, 8 * 37, True),       # the CLI decimation, P = 8
    (7, 4 * 5, True),        # D % 4 != 0, P = 4
])
def test_exact_forms_bitwise(name, d, k, rot):
    rng = np.random.default_rng(23 + d + k)
    blk = _full_range(rng, d, k)
    assert frontend_mxu._pick_p(k, d, rot) >= 2
    got = _port(name, blk, d, rot)
    for want in (_ref(name, blk, d, rot), _plain(blk, d, rot)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("p", [2, 4, 8, 16, 32])
def test_exact_forms_at_every_phase_block(p):
    """An explicit ``p`` takes the same matrix as the reference's."""
    rng = np.random.default_rng(p)
    d, k = 8, 32 * 5
    blk = _full_range(rng, d, k)
    plain = _plain(blk, d, True)
    for name in EXACT_FORMS:
        got = _port(name, blk, d, True, p=p)
        np.testing.assert_array_equal(got[0], plain[0], err_msg=name)
        np.testing.assert_array_equal(got[1], plain[1], err_msg=name)
    ref = _ref("capture_frontend_mm_i8", blk, d, True, p=p)
    np.testing.assert_array_equal(ref[0], plain[0])


@pytest.mark.parametrize("name", ["capture_frontend_mm_i16",
                                  "capture_frontend_mm_i16_2"])
@pytest.mark.parametrize("d", [256, 257])
def test_exact_forms_either_side_of_the_float32_limit(name, d):
    """At D <= 256 every partial sum (at most 2D int16 terms) lies within
    2**24, so the product runs in float32; above, in float64.  Both sides
    stay bitwise, also with every sample at -32768."""
    assert frontend_mxu._MAX_F32_EXACT_D == 256 == 2 ** 24 // (2 * 32768)
    rng = np.random.default_rng(d)
    k = 64
    blk = _full_range(rng, d, k)
    blk[:2 * d * 32] = -32768
    p = frontend_mxu._pick_p(k, d, True)
    prod = frontend_mxu._exact_product(torch.from_numpy(blk), d, p, True)
    assert prod.dtype == (torch.float32 if d <= 256 else torch.float64)
    got = _port(name, blk, d, True)
    for want in (_ref(name, blk, d, True), _plain(blk, d, True)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", FLOAT_FORMS)
def test_float_forms_take_the_reference_precision(name):
    """The reference's ``precision=`` keyword: HIGHEST (its default) is
    what the forms compute; a lower precision is refused, not ignored."""
    rng = np.random.default_rng(3)
    d = 14
    blk = _blk(rng, d, 32 * 3)
    want = _port(name, blk, d, True)
    for prec in (jax.lax.Precision.HIGHEST, "highest", None):
        got = _port(name, blk, d, True, precision=prec)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH):
        with pytest.raises(ValueError):
            _port(name, blk, d, True, precision=prec)


def test_int_mm_padding_rules():
    # torch._int_mm needs more than 16 rows and k, n multiples of 8
    assert frontend_mxu._int_mm_shape(3, 20, 4) == (17, 24, 8)
    assert frontend_mxu._int_mm_shape(18432, 896, 64) == (18432, 896, 64)
    assert frontend_mxu._int_mm_shape(17, 8, 8) == (17, 8, 8)
    m8 = frontend_mxu._int8_matrix(5, 2, False, 24, 8)
    assert m8.dtype == np.int8 and m8.shape == (24, 8)
    np.testing.assert_array_equal(m8[:20, :4],
                                  frontend_mxu._fs4_decim_matrix(5, 2, False))
    assert not m8[20:].any() and not m8[:, 4:].any()


def test_bf16_probe_class():
    # tests/test_frontend_mxu.py:187-198: bf16 inputs, f32 accumulation
    rng = np.random.default_rng(31)
    d = 14
    blk = rng.integers(-2000, 2000, 2 * d * 32 * 24).astype(np.int16)
    zi, zq = _port("capture_frontend_mm_bf16", blk, d, True)
    pi, pq = _plain(blk, d, True)
    for got, plain in ((zi, pi), (zq, pq)):
        assert got.shape == plain.shape and got.dtype == np.float32
        assert np.max(np.abs(got - plain) / (np.abs(plain) + 1.0)) < 0.05
    # the same bfloat16 operands and float32 sums as the reference's
    ri, rq = _ref("capture_frontend_mm_bf16", blk, d, True)
    np.testing.assert_allclose(zi, ri, **MM_TOL)
    np.testing.assert_allclose(zq, rq, **MM_TOL)
    # the probe is inexact: it must not equal the exact head
    assert not np.array_equal(zi, pi)


def test_bf16_probe_class_bound_fails_at_config1_size():
    """The bound of tests/test_frontend_mxu.py:197 holds on that test's
    768 outputs only: at BASELINE config #1's chunk (D = 14, K = 221184,
    the same seed and input range) the reference's own probe exceeds
    0.05, and the port's agrees with it."""
    rng = np.random.default_rng(31)
    d, k = 14, 221184
    blk = rng.integers(-2000, 2000, 2 * d * k).astype(np.int16)
    plain = _plain(blk, d, True)
    ref = _ref("capture_frontend_mm_bf16", blk, d, True)
    port = _port("capture_frontend_mm_bf16", blk, d, True)
    rel = max(np.max(np.abs(r - w) / (np.abs(w) + 1.0))
              for r, w in zip(ref, plain))
    assert rel > 0.05
    for got, want in zip(port, ref):
        np.testing.assert_allclose(got, want, **MM_TOL)


def test_forms_validate_the_stream():
    blk = torch.zeros(2 * 14 * 32 - 2, dtype=torch.int16)
    for name in FLOAT_FORMS + P_FORMS:
        with pytest.raises(ValueError):
            getattr(frontend_mxu, name)(blk, 14)


def test_rms_level_vs_oracle_and_reference():
    # tests/test_ops_demod.py:220-224
    rng = np.random.default_rng(14)
    blk = rng.integers(-120, 120, size=2 * 512).astype(np.int64)
    ref = c_ref.rms(blk, 1)
    x = blk.astype(np.float32).reshape(-1, 2)
    got = float(ops.rms_level(torch.from_numpy(x)))
    assert abs(got - ref) <= max(2.0, 0.01 * ref)
    want = float(ref_fl.rms_level(jnp.asarray(x)))
    assert got == pytest.approx(want, rel=1e-5)
    # one estimator: the planar form of the same samples agrees
    planar = float(ops.rms_level_planar(torch.from_numpy(x[:, 0].copy()),
                                        torch.from_numpy(x[:, 1].copy())))
    assert got == pytest.approx(planar, rel=1e-5)


@pytest.mark.parametrize("shape,offset", [((4104, 2), 3.0), ((1000,), -7.5),
                                          ((17, 3), 0.0)])
def test_mad_level_vs_reference(shape, offset):
    rng = np.random.default_rng(len(shape) + int(abs(offset)))
    x = (rng.standard_normal(shape) * 40 + offset).astype(np.float32)
    want = float(ref_fl.mad_level(jnp.asarray(x)))
    got = float(ops.mad_level(torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("n,fast,slow", [(20, 160000, 32000),
                                         (23, 160000, 32000),
                                         (1000, 96000, 48000),
                                         (4, 170000, 34000),
                                         (7, 48000, 48000)])
def test_resample_divisible_vs_reference(n, fast, slow):
    # tests/test_ops_demod.py:256-259, plus truncated tails
    rng = np.random.default_rng(n)
    x = rng.integers(-10000, 10000, n).astype(np.float32)
    want = np.asarray(ref_rs.resample_divisible(jnp.asarray(x), fast, slow))
    got = ops.resample_divisible(torch.from_numpy(x), fast, slow).numpy()
    assert got.shape == want.shape == (n // (fast // slow),)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if n == 20:
        np.testing.assert_allclose(
            ops.resample_divisible(torch.arange(20.0), fast, slow).numpy(),
            np.arange(20).reshape(4, 5).mean(1))


def test_resample_divisible_refuses_a_fractional_ratio():
    x = torch.zeros(20)
    with pytest.raises(AssertionError):
        ref_rs.resample_divisible(jnp.zeros(20), 170000, 32000)
    with pytest.raises(ValueError):
        ops.resample_divisible(x, 170000, 32000)
