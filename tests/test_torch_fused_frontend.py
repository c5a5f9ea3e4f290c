"""The port's fused front (K2's plain version on the CPU) against the
reference's Pallas kernel in interpret mode, at the reference's own
tolerances (tests/test_fused_frontend.py:33-70)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rx_tools_tpu.ops import fused_frontend as ref_ff
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.ops import frontend_mxu, fused_frontend

torch.set_num_threads(2)


def _port(prev, blk, d, kpb):
    got = fused_frontend.fused_capture_fm_demod(
        torch.from_numpy(np.asarray(prev)), torch.from_numpy(blk), d, kpb)
    return [t.numpy() for t in got]


@pytest.mark.parametrize("kpb,m", [(4096, 3),     # 1 reference tile/block
                                   (9216, 1)])    # 3 reference tiles/block
def test_fused_matches_reference_kernel(kpb, m):
    rng = np.random.default_rng(3)
    d = 14
    blk = rng.integers(-16000, 16000, m * kpb * 2 * d).astype(np.int16)
    prev = np.float32([3.0, -2.0])
    p_ref, d_ref, lv_ref = ref_ff.fused_capture_fm_demod(
        jnp.asarray(prev), jnp.asarray(blk), d, kpb, interpret=True)
    p_got, d_got, lv_got = _port(prev, blk, d, kpb)
    np.testing.assert_allclose(d_got, np.asarray(d_ref), atol=5e-2)
    np.testing.assert_allclose(lv_got, np.asarray(lv_ref), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(p_got, np.asarray(p_ref), atol=1e-3)


def test_fused_chains_like_reference():
    """Carried prev_iq across two chunk calls: the second chunk's first
    seam uses the first chunk's last pair."""
    rng = np.random.default_rng(9)
    d = 14
    kpb = 4096
    b1 = rng.integers(-8000, 8000, 2 * kpb * 2 * d).astype(np.int16)
    b2 = rng.integers(-8000, 8000, 2 * kpb * 2 * d).astype(np.int16)
    prev = jnp.zeros(2, jnp.float32)
    pr_a, _, _ = ref_ff.fused_capture_fm_demod(prev, jnp.asarray(b1), d, kpb,
                                               interpret=True)
    pr_b, db, _ = ref_ff.fused_capture_fm_demod(pr_a, jnp.asarray(b2), d,
                                                kpb, interpret=True)
    pg_a, _, _ = _port(np.zeros(2, np.float32), b1, d, kpb)
    pg_b, gb, _ = _port(pg_a, b2, d, kpb)
    np.testing.assert_allclose(gb, np.asarray(db), atol=5e-2)
    np.testing.assert_allclose(pg_b, np.asarray(pr_b), atol=1e-3)


@pytest.mark.parametrize("d,kpb,m", [(6, 1368, 3), (14, 100, 2)])
def test_fused_matches_unfused_port(d, kpb, m):
    """Any block length (no TPU tile gate): the fused front equals the
    port's unfused composition — head + fast-atan discriminator with block
    seams + rms levels — at the same tolerances."""
    rng = np.random.default_rng(11)
    blk = torch.from_numpy(
        rng.integers(-16000, 16000, m * kpb * 2 * d).astype(np.int16))
    prev = torch.tensor([1.5, 0.5])
    p_got, d_got, lv_got = fused_frontend.fused_capture_fm_demod(
        prev, blk, d, kpb)
    zi, zq = frontend_mxu.capture_head_plain(blk, d)
    p_ref, d_ref = ops.fm_discriminate_planar(prev, zi, zq, ops.DISC_FAST,
                                              seam_stride=kpb)
    lv_ref = torch.stack([ops.rms_level_planar(zi[i * kpb:(i + 1) * kpb],
                                               zq[i * kpb:(i + 1) * kpb])
                          for i in range(m)])
    np.testing.assert_allclose(d_got.numpy(), d_ref.numpy(), atol=5e-2)
    # the seams are the same std atan2 of the same pair
    np.testing.assert_array_equal(d_got[::kpb].numpy(), d_ref[::kpb].numpy())
    np.testing.assert_allclose(lv_got.numpy(), lv_ref.numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(p_got.numpy(), p_ref.numpy())


def test_eligibility_gates(monkeypatch):
    base = dict(mode="fm", rate_in=171428, rate_out=171428, rate_out2=32000,
                downsample=14, custom_atan=1, deemph_a=13, squelch_level=0.0)
    ok = fmchain.FmConfig(**base)
    monkeypatch.delenv("RX_FUSED", raising=False)
    k = 1368
    assert not fused_frontend.fused_eligible(ok, k)       # opt-in
    assert fused_frontend.fused_eligible(ok, k, fused=True)
    monkeypatch.setenv("RX_FUSED", "1")
    assert fused_frontend.fused_eligible(ok, k)
    assert not fused_frontend.fused_eligible(ok, k, fused=False)
    for bad in (dict(custom_atan=0), dict(mode="am"),
                dict(squelch_level=1.0), dict(dc_block_raw=True),
                dict(downsample_passes=2)):
        cfg = fmchain.FmConfig(**{**base, **bad})
        assert not fused_frontend.fused_eligible(cfg, k, fused=True)
