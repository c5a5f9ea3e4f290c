"""Calls written for the reference package bind the same in the port.

Each function below once took other parameters in the port than in
``rx_tools_tpu`` (a JAX-style call raised ``TypeError`` or, for
``fused_eligible``, read an int as a switch).  Here each is called as the
reference is called, positionally, on the same inputs, and held to the
reference's result; where the port cannot do what the call asks (the
Pallas interpreter, a TPU tile height, a precision below HIGHEST) it
raises ``ValueError``.  ``tests/test_torch_inventory.py`` holds every
signature by AST; this file holds the behaviour behind the repaired
ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu.models import fmchain as jfmchain
from rx_tools_tpu.ops import fused_frontend as ref_ff
from rx_tools_tpu.ops import frontend_mxu as ref_mxu
from rx_tools_tpu.ops import intfft as ref_intfft
from rx_tools_tpu.ops import pallas_frontend as ref_pf
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.iq.sources import make_source
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.ops import (frontend_mxu, fused_frontend, intfft,
                                   pallas_frontend)
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner

torch.set_num_threads(2)

HI = jax.lax.Precision.HIGHEST
MM_TOL = dict(rtol=2e-5, atol=5e-3)         # tests/test_torch_frontend.py:19
K3_TOL = dict(rtol=1e-6, atol=1e-3)         # tests/test_torch_frontend.py:106


def _cfgs(**kw):
    base = dict(mode="fm", rate_in=171428, rate_out=171428, rate_out2=32000,
                downsample=14, custom_atan=1, deemph_a=13)
    base.update(kw)
    return fmchain.FmConfig(**base), jfmchain.FmConfig(**base)


@pytest.mark.parametrize("kw", [{}, dict(custom_atan=0), dict(mode="am")],
                         ids=["eligible", "std-atan", "am"])
@pytest.mark.parametrize("k", [1368, 4096])
def test_fused_eligible_jax_style_equals_reference(monkeypatch, kw, k):
    """``fused_eligible(cfg, k)`` with ``RX_FUSED`` unset: False, as the
    reference answers off the TPU (it used to read ``k`` as
    ``fused=True``)."""
    monkeypatch.delenv("RX_FUSED", raising=False)
    cfg, jcfg = _cfgs(**kw)
    assert ref_ff.fused_eligible(jcfg, k) is False
    assert fused_frontend.fused_eligible(cfg, k) is False
    # the opt-in, by keyword, still selects the kernel where it applies
    assert fused_frontend.fused_eligible(cfg, k, fused=True) is (not kw)


def test_fused_eligible_needs_a_block():
    cfg, _ = _cfgs()
    for k in (0, -14):
        assert fused_frontend.fused_eligible(cfg, k, fused=True) is False


@pytest.mark.parametrize("ds", [1, 2])
def test_int_hop_segments_peak_hold_bitwise(ds):
    """``peak_hold`` binds and changes nothing, as in the reference."""
    rng = np.random.default_rng(7)
    bin_e = 5
    iq = rng.integers(-32768, 32767, 16 * ds * (1 << bin_e)).astype(np.int16)
    win = ops.window_coefs_int("hamming", 1 << bin_e)
    want = ref_intfft.int_hop_segments(jnp.asarray(iq), jnp.asarray(win),
                                       bin_e, ds, True)
    got = intfft.int_hop_segments(torch.from_numpy(iq),
                                  torch.from_numpy(win), bin_e, ds, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), intfft.int_hop_segments(torch.from_numpy(iq),
                                             torch.from_numpy(win), bin_e,
                                             ds).numpy())


def _heads(blk, d):
    """K1, K4 and K3 of both packages called with the reference's
    positional arguments (the reference in interpret mode, the port with
    ``interpret=False`` on a CPU tensor)."""
    x, jx = torch.from_numpy(blk), jnp.asarray(blk)
    return {
        "K1": (frontend_mxu.capture_frontend_mm_pallas(x, d, True, 32, 128,
                                                       HI, False),
               ref_mxu.capture_frontend_mm_pallas(jx, d, True, 32, 128, HI,
                                                  True), MM_TOL),
        "K4": (frontend_mxu.capture_frontend_mm_pallas2(x, d, True, 32, 256,
                                                        False),
               ref_mxu.capture_frontend_mm_pallas2(jx, d, True, 32, 256,
                                                   True), MM_TOL),
        "K3": ((pallas_frontend.capture_frontend_pallas(x, d, True, False),),
               (ref_pf.capture_frontend_pallas(jx, d, True, True),), K3_TOL),
    }


@pytest.mark.parametrize("d", [6, 14])
def test_heads_jax_positional_calls(d):
    """On full-scale samples the reference rounds each scaled term before
    summing (a float32 product) while the port sums the integers exactly,
    so they agree at the head tests' classes; on samples of -32767, 0 and
    32767 every scaled term is exactly -128, 0 or 128 and both are exact,
    so they agree bit for bit."""
    rng = np.random.default_rng(d)
    k = 32 * 136
    full = rng.integers(-32768, 32767, 2 * d * k).astype(np.int16)
    rails = rng.choice(np.int16([-32767, 0, 32767]), 2 * d * k)
    for name, (got, want, tol) in _heads(full, d).items():
        for g, w in zip(got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                       err_msg=name)
    for name, (got, want, _) in _heads(rails, d).items():
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def test_fused_demod_jax_positional_call():
    """``fused_capture_fm_demod`` with the reference's positional
    arguments, at tests/test_torch_fused_frontend.py's classes."""
    rng = np.random.default_rng(3)
    d, kpb, m = 14, 4096, 2
    blk = rng.integers(-16000, 16000, m * kpb * 2 * d).astype(np.int16)
    prev = np.float32([3.0, -2.0])
    want = ref_ff.fused_capture_fm_demod(jnp.asarray(prev), jnp.asarray(blk),
                                         d, kpb, True, True)
    got = fused_frontend.fused_capture_fm_demod(
        torch.from_numpy(prev), torch.from_numpy(blk), d, kpb, True, False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=5e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("call,match", [
    (lambda x: frontend_mxu.capture_frontend_mm_pallas(x, 6, tile_rows=64),
     "kernels/plan.py"),
    (lambda x: frontend_mxu.capture_frontend_mm_pallas2(x, 6, tile_rows=64),
     "kernels/plan.py"),
    (lambda x: frontend_mxu.capture_frontend_mm_pallas(x, 6, interpret=True),
     "interpret"),
    (lambda x: frontend_mxu.capture_frontend_mm_pallas2(x, 6,
                                                        interpret=True),
     "interpret"),
    (lambda x: pallas_frontend.capture_frontend_pallas(x, 6, interpret=True),
     "interpret"),
    (lambda x: fused_frontend.fused_capture_fm_demod(
        torch.zeros(2), x, 6, 48, interpret=True), "interpret"),
    (lambda x: frontend_mxu.capture_frontend_mm_pallas(
        x, 6, precision=jax.lax.Precision.DEFAULT), "HIGHEST"),
    (lambda x: frontend_mxu.capture_frontend_mm_pallas(
        x, 6, precision="bfloat16"), "HIGHEST"),
], ids=["k1-tile", "k4-tile", "k1-interpret", "k4-interpret",
        "k3-interpret", "k2-interpret", "k1-default-precision",
        "k1-bf16-precision"])
def test_what_the_port_cannot_do_raises_value_error(call, match):
    x = torch.zeros(2 * 6 * 48, dtype=torch.int16)
    with pytest.raises(ValueError, match=match):
        call(x)


def test_chunked_runner_jax_positional_order(tmp_path):
    """``ChunkedFmRunner(cfg, source, sink, chunk, block_size, on_squelch,
    exit_on_squelch, checkpoint_path, checkpoint_every)``, the reference's
    order, writes the checkpoint it names."""
    cfg, _ = _cfgs(rate_in=170000, rate_out=170000, downsample=6,
                   deemph_a=7)
    n = fmchain.block_samples(cfg, target=480)
    ckpt = tmp_path / "st.npz"
    out = []
    runner = ChunkedFmRunner(cfg, make_source("synth=fm,seed=1"),
                             lambda a, lvl: out.append(a.copy()), 2, n, None,
                             False, str(ckpt), 4, device="cpu")
    assert runner.checkpoint_path == str(ckpt)
    assert runner.checkpoint_every == 4
    runner.run(max_blocks=8)
    assert ckpt.exists() and out
