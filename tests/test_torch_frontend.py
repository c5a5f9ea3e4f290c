"""The port's capture head (K1, K3, K4 and their plain version) against the
reference package on the CPU: integer-exact against the raw-int16 dot
``capture_frontend_mm_i16`` wherever it runs as a dot (p >= 2), and against
the Pallas kernels in interpret mode at their own tests' tolerances."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rx_tools_tpu.ops import frontend_mxu as ref_mxu
from rx_tools_tpu.ops import pallas_frontend as ref_pf
from rx_tools_tpu_torch.ops import frontend_mxu, pallas_frontend

torch.set_num_threads(2)

# tests/test_frontend_mxu.py:79-96 (f32 dot / masked path vs exact sums)
MM_TOL = dict(rtol=2e-5, atol=5e-3)


def _blk(rng, d, k, lo=-32768, hi=32767):
    return rng.integers(lo, hi, 2 * d * k).astype(np.int16)


def _layouts(blk, d, rot):
    """The three layouts of the port's head on a CPU tensor, as planar
    numpy pairs: K1 planar, K4 two-output, K3 interleaved."""
    x = torch.from_numpy(blk)
    k1 = frontend_mxu.capture_frontend_mm_pallas(x, d, rot)
    k4 = frontend_mxu.capture_frontend_mm_pallas2(x, d, rot)
    k3 = pallas_frontend.capture_frontend_pallas(x, d, rot)
    return {"K1": (k1[0].numpy(), k1[1].numpy()),
            "K4": (k4[0].numpy(), k4[1].numpy()),
            "K3": (k3[:, 0].numpy(), k3[:, 1].numpy())}


@pytest.mark.parametrize("d,k,rot", [
    (14, 32 * 20, True),     # the bench geometry class, P = 32
    (6, 8 * 37, True),       # the CLI decimation, P = 8
    (8, 16 * 9, True),       # D % 4 == 0
    (14, 32 * 7, False),     # offset tuning: no rotation
    (6, 2 * 49, False),      # P = 2 (no fs/4 phase to tile)
    (8, 33, True),           # odd K: p == 1
    (6, 35, True),           # odd K, D % 4 != 0: p == 1
    (14, 33, False),         # odd K without rotation: p == 1
])
def test_head_matches_mm_i16(d, k, rot):
    rng = np.random.default_rng(100 + d + k)
    blk = _blk(rng, d, k)
    p = ref_mxu._pick_p(k, d, rot)
    zi0, zq0 = (np.asarray(v) for v in
                ref_mxu.capture_frontend_mm_i16(jnp.asarray(blk), d, rot))
    for name, (zi, zq) in _layouts(blk, d, rot).items():
        assert zi.shape == zi0.shape and zq.shape == zq0.shape, name
        if p >= 2:
            # both are exact integer sums scaled once: bit for bit
            np.testing.assert_array_equal(zi, zi0, err_msg=name)
            np.testing.assert_array_equal(zq, zq0, err_msg=name)
        else:
            # the reference falls back to its f32 masked reduce at p == 1
            np.testing.assert_allclose(zi, zi0, err_msg=name, **MM_TOL)
            np.testing.assert_allclose(zq, zq0, err_msg=name, **MM_TOL)
    # the port's matrix-form integer head equals its plain version
    zi2, zq2 = frontend_mxu.capture_frontend_mm_i16(torch.from_numpy(blk),
                                                    d, rot)
    np.testing.assert_array_equal(zi2.numpy(), _layouts(blk, d, rot)["K1"][0])
    np.testing.assert_array_equal(zq2.numpy(), _layouts(blk, d, rot)["K1"][1])


@pytest.mark.parametrize("k,p", [(32 * 136, 32),   # ragged: 136 % 128 != 0
                                 (8 * 5, 8)])      # tiny single ragged tile
def test_k1_matches_pallas_interpret(k, p):
    rng = np.random.default_rng(17)
    d = 14
    blk = _blk(rng, d, k)
    zi0, zq0 = ref_mxu.capture_frontend_mm_pallas(
        jnp.asarray(blk), d, True, p=p, interpret=True)
    zi1, zq1 = frontend_mxu.capture_frontend_mm_pallas(torch.from_numpy(blk),
                                                       d, True)
    np.testing.assert_allclose(zi1.numpy(), np.asarray(zi0), **MM_TOL)
    np.testing.assert_allclose(zq1.numpy(), np.asarray(zq0), **MM_TOL)


def test_k4_matches_pallas2_interpret():
    rng = np.random.default_rng(29)
    d = 14
    blk = _blk(rng, d, 32 * 130, -32000, 32000)
    zi0, zq0 = ref_mxu.capture_frontend_mm_pallas2(jnp.asarray(blk), d, True,
                                                   interpret=True)
    zi1, zq1 = frontend_mxu.capture_frontend_mm_pallas2(
        torch.from_numpy(blk), d, True)
    np.testing.assert_allclose(zi1.numpy(), np.asarray(zi0), **MM_TOL)
    np.testing.assert_allclose(zq1.numpy(), np.asarray(zq0), **MM_TOL)


@pytest.mark.parametrize("d,rot,rows", [(14, True, 64), (42, False, 64),
                                        (8, True, 64), (6, True, 63),
                                        (6, False, 63)])
def test_k3_matches_pallas_interpret(d, rot, rows):
    # tests/test_pallas_frontend.py:14-19
    rng = np.random.default_rng(0)
    blk = _blk(rng, d, rows)
    a = np.asarray(ref_pf.capture_frontend_pallas(blk, d, rot,
                                                  interpret=True))
    b = pallas_frontend.capture_frontend_pallas(torch.from_numpy(blk), d,
                                                rot).numpy()
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-3)


def test_tables_equal_reference():
    for d in range(1, 17):
        for rot in (True, False):
            for got, want in zip(pallas_frontend._fs4_decim_masks(d, rot),
                                 ref_pf._fs4_decim_masks(d, rot)):
                np.testing.assert_array_equal(got, want)
            for p in (2, 4, 8, 16, 32):
                if rot and d % 4 and p % 4:
                    continue
                np.testing.assert_array_equal(
                    frontend_mxu._fs4_decim_matrix(d, p, rot),
                    ref_mxu._fs4_decim_matrix(d, p, rot))
            for k in range(1, 70):
                assert (frontend_mxu._pick_p(k, d, rot)
                        == ref_mxu._pick_p(k, d, rot))
    assert pallas_frontend._SCALE == ref_pf._SCALE


def test_planar_dispatch_is_k1_on_cpu():
    rng = np.random.default_rng(5)
    blk = torch.from_numpy(_blk(rng, 6, 40))
    before = frontend_mxu.capture_frontend_mm_pallas.launches
    zi, zq = pallas_frontend.capture_frontend_planar(blk, 6, True)
    p_zi, p_zq = frontend_mxu.capture_head_plain(blk, 6, True)
    assert torch.equal(zi, p_zi) and torch.equal(zq, p_zq)
    # the CPU runs the plain version: no kernel launch is counted
    assert frontend_mxu.capture_frontend_mm_pallas.launches == before
    with pytest.raises(ValueError):
        pallas_frontend.capture_frontend_planar(blk[:-2], 6, True)
