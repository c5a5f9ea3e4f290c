"""The port's ``entry.dryrun_multichip`` against the reference's
``__graft_entry__.dryrun_multichip``: the same five sharded steps on the
same seeded inputs, the port on a mesh of eight ``cpu`` entries, the JAX
package on conftest's 8 virtual CPU devices, at the classes of
tests/test_torch_parallel.py (time shards rtol 1e-4 / atol 0.1, the sweep
rtol 1e-6 with exact sample counts) and tests/test_pfb.py:174-176 (the
PFB, scaled by the channel's peak)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from rx_tools_tpu import parallel as jpar
from rx_tools_tpu.models import fmchain as jfmchain
from rx_tools_tpu.models import pfb as jpfb
from rx_tools_tpu.models import powerscan as jpowerscan
from rx_tools_tpu_torch import entry

torch.set_num_threads(2)

N = 8
TS_TOL = dict(rtol=1e-4, atol=0.1)          # tests/test_parallel.py:60
PFB_TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_pfb.py:174-176
#: __graft_entry__.py:45-80's three time-sharded configs
VARIANTS = {"fm_raw_dc": dict(dc_block_raw=True), "fm_exact": {},
            "fm_dc": dict(dc_block_audio=True)}


def _reference_outputs(n_dev):
    """``__graft_entry__.dryrun_multichip``'s steps and configs, keeping
    the outputs that it only asserts on."""
    out = {}
    mesh_t = jpar.make_mesh(n_dev, axis="t")
    base = dict(mode="fm", rate_in=170000, rate_out=170000,
                rate_out2=32000, downsample=6, custom_atan=1, deemph_a=7)
    cfgs = {name: jfmchain.FmConfig(**base, **extra)
            for name, extra in VARIANTS.items()}
    n = jfmchain.block_samples(cfgs["fm_raw_dc"], target=96)
    rng = np.random.default_rng(0)
    iq = rng.integers(-2000, 2000, 2 * n_dev * 3 * n).astype(np.int16)
    sharded = jnp.asarray(jpar.shard_recording(iq, n_dev, n))
    for name, cfg in cfgs.items():
        out[name] = jax.device_get(jpar.time_sharded_fm(
            cfg, sharded, mesh=mesh_t, warmup=1))
    pc = jpfb.PfbConfig(capture_rate=1_024_000, n_channels=2 * n_dev,
                        mode="fm", custom_atan=1, deemph_a=7,
                        rate_out2=32_000)
    pn = jpfb.block_samples(pc, target=4096)
    block = rng.integers(-3000, 3000, 2 * pn).astype(np.int16)
    _, pa, pnv = jpar.channel_sharded_pfb_step(
        pc, jpfb.init_state(pc), jnp.asarray(block),
        jpar.make_mesh(n_dev, axis="c"))
    out["pfb"] = jax.device_get((pa, pnv))
    pcfg = jpowerscan.PowerConfig(bin_e=5, downsample=1, buf_len=128)
    hops = 2 * n_dev
    blocks = rng.integers(-3000, 3000, (hops, pcfg.buf_len)).astype(np.int16)
    acc = jpar.hop_sharded_sweep(pcfg, jpowerscan.new_sweep_accum(hops, pcfg),
                                 blocks, jpar.make_mesh(n_dev, axis="h"))
    out["sweep"] = jax.device_get((acc.avg, acc.samples))
    return out


@pytest.fixture(scope="module")
def outputs():
    return (entry._dryrun_outputs(N, "cpu"), _reference_outputs(N))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_time_sharded_variants_match_reference(outputs, name):
    got, want = outputs
    assert list(got) == list(VARIANTS) + ["pfb", "sweep"]
    audio, n_valid, carry = (x.numpy() for x in got[name])
    j_audio, j_valid, j_carry = (np.asarray(x) for x in want[name])
    assert audio.shape == j_audio.shape and audio.shape[0] == N
    np.testing.assert_array_equal(n_valid, j_valid)
    for s in range(N):
        for b in range(n_valid.shape[1]):
            k = int(n_valid[s, b])
            np.testing.assert_allclose(audio[s, b, :k], j_audio[s, b, :k],
                                       **TS_TOL, err_msg=f"shard {s} "
                                       f"block {b}")
    assert carry.shape == j_carry.shape == (N, 3)
    np.testing.assert_allclose(carry, j_carry, **TS_TOL)


def test_channel_sharded_pfb_matches_reference(outputs):
    got, want = outputs
    audio, n_valid = (x.numpy() for x in got["pfb"])
    j_audio, j_valid = (np.asarray(x, np.float64) for x in want["pfb"])
    assert audio.shape == j_audio.shape and audio.shape[0] == 2 * N
    np.testing.assert_array_equal(n_valid, j_valid)
    for ch in range(2 * N):
        k = int(n_valid[ch])
        scale = max(1.0, float(np.abs(j_audio[ch, :k]).max(initial=0)))
        np.testing.assert_allclose(audio[ch, :k] / scale,
                                   j_audio[ch, :k] / scale, **PFB_TOL,
                                   err_msg=f"channel {ch}")


def test_hop_sharded_sweep_matches_reference(outputs):
    got, want = outputs
    avg, samples = (x.numpy() for x in got["sweep"])
    j_avg, j_samples = (np.asarray(x) for x in want["sweep"])
    assert avg.shape == j_avg.shape == (2 * N, 32)
    np.testing.assert_allclose(avg, j_avg, rtol=1e-6)
    np.testing.assert_array_equal(samples, j_samples)


def test_both_dry_runs_complete():
    """The port's dry run on eight ``cpu`` entries, and the reference's on
    conftest's 8 virtual devices (its ``jax.config.update`` raises after
    the backend started and it catches that itself)."""
    assert entry.dryrun_multichip(N, device="cpu") is None
    assert __graft_entry__.dryrun_multichip(N) is None


def test_mesh_repeats_the_device():
    """One device repeated when the machine has fewer than n distinct
    ones: the CPU, as one card runs ``[cuda:0] * n``."""
    assert entry._mesh_devices(4, "cpu") == [torch.device("cpu")] * 4


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    """The dry run never picks the CPU on its own."""
    monkeypatch.delenv("RX_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    entry.dryrun_multichip(2)
