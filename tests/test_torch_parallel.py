"""The port's sharded execution (``rx_tools_tpu_torch/parallel``) against
the reference package's on the same seeded inputs, case for case with
tests/test_parallel.py: time shards with halo warm-up against the unsharded
scan and the JAX ``time_sharded_fm``, hop shards against the batched sweep,
channel shards against the single-device PFB step, and the exchange counts
that stand for the reference's HLO collective asserts.  The port's meshes
repeat the ``cpu`` device; the JAX side runs on conftest's 8 virtual CPU
devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu.models import fmchain as jfmchain
from rx_tools_tpu.models import pfb as jpfb
from rx_tools_tpu.models import powerscan as jpowerscan
from rx_tools_tpu import parallel as jpar
from rx_tools_tpu_torch.device import local_devices
from rx_tools_tpu_torch.models import fmchain, pfb, powerscan
from rx_tools_tpu_torch.parallel import (channel_sharded_pfb_step,
                                         hop_sharded_sweep, make_mesh,
                                         shard_recording, time_sharded_fm)
from rx_tools_tpu_torch.parallel.hopshard import int_hop_sharded
from rx_tools_tpu_torch.parallel.mesh import EXCHANGES, Mesh
from rx_tools_tpu_torch.parallel.timeshard import (exact_iir_supported,
                                                   resampler_modulus)
from rx_tools_tpu_torch.stream.scan import scan_fm_blocks, stack_blocks

torch.set_num_threads(2)

S = 4          # shards
WARMUP = 2
TS_TOL = dict(rtol=1e-4, atol=0.1)          # tests/test_parallel.py:60


def _cfgs(**kw):
    base = dict(mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
                downsample=6, custom_atan=1, deemph_a=7)
    base.update(kw)
    return fmchain.FmConfig(**base), jfmchain.FmConfig(**base)


def _recording(cfg, blocks_per_shard=4, seed=0):
    n = fmchain.block_samples(cfg, target=480)
    rng = np.random.default_rng(seed)
    return (rng.integers(-2000, 2000, 2 * S * blocks_per_shard * n)
            .astype(np.int16), n)


def _fm_dc_recording(cfg, blocks_per_shard=4, seed=0, offset_hz=5000.0):
    """tests/test_parallel.py:63-79: an FM capture with a carrier offset,
    so the discriminator output carries a large DC level and the audio DC
    block's state matters at every seam."""
    n = fmchain.block_samples(cfg, target=480)
    total = S * blocks_per_shard * n
    fs = cfg.rate_in * cfg.downsample
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * (offset_hz / fs) * np.arange(total)
    iq = np.empty(2 * total, np.int16)
    iq[0::2] = np.round(8000 * np.cos(ph)
                        + rng.normal(0, 300, total)).astype(np.int16)
    iq[1::2] = np.round(8000 * np.sin(ph)
                        + rng.normal(0, 300, total)).astype(np.int16)
    return iq, n


def _cpu_mesh(n, axis="t"):
    return make_mesh(devices=["cpu"] * n, axis=axis)


def _flat(audio, n_valid):
    audio, n_valid = np.asarray(audio), np.asarray(n_valid)
    return [np.concatenate([audio[s, i, : n_valid[s, i]]
                            for i in range(audio.shape[1])])
            for s in range(audio.shape[0])]


def _assert_sharded(cfg, jcfg, iq, n, warmup=WARMUP, atol=0.1,
                    per_shard=True):
    """Port shards == the port's unsharded scan and == the JAX sharded run
    (same counts, rtol 1e-4 at ``atol``)."""
    sharded = shard_recording(iq, S, n)
    audio, nv, _ = time_sharded_fm(cfg, sharded, mesh=_cpu_mesh(S),
                                   warmup=warmup)
    assert audio.shape[:2] == (S, sharded.shape[1])
    _, au, nvu, _ = scan_fm_blocks(cfg, fmchain.init_state(cfg, "cpu"),
                                   sharded.reshape(-1, sharded.shape[-1]))
    au = au.numpy().reshape(S, -1, au.shape[-1])
    nvu = nvu.numpy().reshape(S, -1)
    ja, jnv, _ = jpar.time_sharded_fm(jcfg, jnp.asarray(sharded),
                                      mesh=jpar.make_mesh(S), warmup=warmup)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    if not per_shard:
        # fixed-capacity rows, compared whole (no resampler: all valid)
        np.testing.assert_allclose(audio.numpy(), au, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(audio.numpy(), np.asarray(ja), rtol=1e-4,
                                   atol=atol)
        return
    for s, (got, ref, jref) in enumerate(zip(
            _flat(audio, nv), _flat(au, nvu), _flat(ja, jnv))):
        # the emission grids coincide (phase seeded analytically)
        assert got.shape == ref.shape == jref.shape, s
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol,
                                   err_msg=f"shard {s} vs unsharded")
        np.testing.assert_allclose(got, jref, rtol=1e-4, atol=atol,
                                   err_msg=f"shard {s} vs reference")


def test_time_sharded_matches_unsharded():
    """The exact IIR hand-off: every shard matches the unsharded run with
    no skip window (tests/test_parallel.py:34-60)."""
    cfg, jcfg = _cfgs()
    iq, n = _recording(cfg)
    _assert_sharded(cfg, jcfg, iq, n)


@pytest.mark.parametrize("kw", [
    dict(dc_block_audio=True),                            # deemph+DC+resample
    dict(dc_block_audio=True, deemph_a=0),                # DC + resample
    dict(dc_block_audio=True, rate_out2=-1),              # deemph + DC
    dict(dc_block_audio=True, deemph_a=0, rate_out2=-1),  # DC alone
], ids=["deemph-dc-rs", "dc-rs", "deemph-dc", "dc"])
def test_time_sharded_audio_dc_exact(kw):
    """``-E dc`` rides the exact closed-form seam
    (tests/test_parallel.py:102-118)."""
    cfg, jcfg = _cfgs(**kw)
    assert exact_iir_supported(cfg)
    iq, n = _fm_dc_recording(cfg, seed=3)
    _assert_sharded(cfg, jcfg, iq, n)


def test_time_sharded_fifth_order_path():
    """The halo warm-up also restores the fifth-order + droop state; the
    stateful head takes the scan's per-block loop
    (tests/test_parallel.py:121-135, warmup 1, atol 0.05)."""
    cfg, jcfg = _cfgs(deemph_a=0, rate_out2=-1, downsample=4,
                      downsample_passes=2, comp_fir_size=9)
    iq, n = _recording(cfg, seed=7)
    _assert_sharded(cfg, jcfg, iq, n, warmup=1, atol=0.05, per_shard=False)


def test_time_sharded_no_iir_exact():
    """No deemph, no DC: the halo warm-up is exact everywhere
    (tests/test_parallel.py:138-151)."""
    cfg, jcfg = _cfgs(deemph_a=0, rate_out2=-1)
    iq, n = _recording(cfg, seed=1)
    _assert_sharded(cfg, jcfg, iq, n, warmup=1, atol=0.05, per_shard=False)


@pytest.mark.parametrize("dc", [False, True])
def test_time_sharded_superchunk_continuation_exact(dc):
    """Two super-chunks, the second with ``cont=True`` and the first's
    exact carry, reproduce the unsharded run on every shard of both
    (tests/test_parallel.py:280-324), and the JAX two-chunk run."""
    cfg, jcfg = _cfgs(dc_block_audio=dc)
    n = fmchain.block_samples(cfg, target=480)
    m = 4
    if dc:
        iq, _ = _fm_dc_recording(cfg, blocks_per_shard=2 * m, seed=21)
    else:
        rng = np.random.default_rng(21)
        iq = rng.integers(-2000, 2000, 2 * 2 * S * m * n).astype(np.int16)
    blocks = stack_blocks(iq, n)
    fmod = resampler_modulus(cfg)
    _, au, nvu, _ = scan_fm_blocks(cfg, fmchain.init_state(cfg, "cpu"),
                                   blocks)
    ref = np.concatenate([au[i, : int(nvu[i])].numpy()
                          for i in range(blocks.shape[0])])
    c1 = blocks[: S * m].reshape(S, m, -1)
    c2 = blocks[S * m:].reshape(S, m, -1)
    halo = blocks[S * m - WARMUP: S * m]
    mesh = _cpu_mesh(S)
    a1, nv1, carry1 = time_sharded_fm(cfg, c1, mesh=mesh, warmup=WARMUP)
    a2, nv2, _ = time_sharded_fm(cfg, c2, mesh=mesh, warmup=WARMUP,
                                 cont=True, halo0=halo,
                                 block_offset_mod=(S * m) % fmod,
                                 iir_carry=carry1[-1])
    jmesh = jpar.make_mesh(S)
    ja1, jnv1, jcarry1 = jpar.time_sharded_fm(jcfg, jnp.asarray(c1),
                                              mesh=jmesh, warmup=WARMUP)
    ja2, jnv2, _ = jpar.time_sharded_fm(
        jcfg, jnp.asarray(c2), mesh=jmesh, warmup=WARMUP, cont=True,
        halo0=jnp.asarray(halo), block_offset_mod=jnp.int32((S * m) % fmod),
        iir_carry=jnp.asarray(jcarry1)[-1])
    got = np.concatenate(_flat(a1, nv1) + _flat(a2, nv2))
    jgot = np.concatenate(_flat(ja1, jnv1) + _flat(ja2, jnv2))
    assert got.shape == ref.shape == jgot.shape
    np.testing.assert_allclose(got, ref, **TS_TOL)
    np.testing.assert_allclose(got, jgot, **TS_TOL)
    np.testing.assert_allclose(carry1.numpy(), np.asarray(jcarry1),
                               rtol=1e-4, atol=0.1)


def test_time_sharded_exchange_counts():
    """The reference's only communication (tests/test_parallel.py:183-216):
    the warm-up path makes one halo exchange a call; the exact path the
    halo exchange plus one gather (``-E dc`` rides the same gather); the
    raw DC block stays on the warm-up path."""
    mesh = _cpu_mesh(S)
    for kw, gathers in ((dict(deemph_a=0, rate_out2=-1), 0), ({}, 1),
                        (dict(dc_block_audio=True), 1)):
        cfg, _ = _cfgs(**kw)
        n = fmchain.block_samples(cfg, target=480)
        before = EXCHANGES.copy()
        time_sharded_fm(cfg, np.zeros((S, 3, 2 * n), np.int16), mesh=mesh,
                        warmup=1)
        diff = EXCHANGES - before
        assert dict(diff) == ({"halo": 1, "gather": 1} if gathers
                              else {"halo": 1}), (kw, diff)
    assert not exact_iir_supported(_cfgs(dc_block_raw=True)[0])
    assert exact_iir_supported(_cfgs()[0])


def test_time_sharded_counts_k1_per_shard_and_halo(monkeypatch):
    """The chunk-wide front runs the capture head once for each shard and
    once for each halo replay (the count chip_smoke.py reads)."""
    from rx_tools_tpu_torch.ops import pallas_frontend
    calls = []
    real = pallas_frontend.capture_frontend_planar

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(pallas_frontend, "capture_frontend_planar", counting)
    from rx_tools_tpu_torch import ops
    monkeypatch.setattr(ops, "capture_frontend_planar", counting)
    cfg, _ = _cfgs()
    iq, n = _recording(cfg)
    time_sharded_fm(cfg, shard_recording(iq, S, n), mesh=_cpu_mesh(S))
    assert len(calls) == 2 * S


def test_time_sharded_argument_checks():
    cfg, _ = _cfgs()
    n = fmchain.block_samples(cfg, target=480)
    with pytest.raises(ValueError, match="mesh"):
        time_sharded_fm(cfg, np.zeros((3, 4, 2 * n), np.int16),
                        mesh=_cpu_mesh(S))
    with pytest.raises(ValueError, match="warmup"):
        time_sharded_fm(cfg, np.zeros((S, 2, 2 * n), np.int16),
                        mesh=_cpu_mesh(S), warmup=3)


def test_mesh_devices(monkeypatch):
    """``local_devices`` on a CPU request follows ``JAX_NUM_CPU_DEVICES``
    (the reference's ``jax_num_cpu_devices``); a CUDA mesh without CUDA
    raises."""
    monkeypatch.setenv("JAX_NUM_CPU_DEVICES", "3")
    assert local_devices("cpu") == [torch.device("cpu")] * 3
    monkeypatch.delenv("JAX_NUM_CPU_DEVICES")
    assert local_devices("cpu") == [torch.device("cpu")]
    mesh = make_mesh(2, devices=["cpu"] * 8, axis="h")
    assert mesh.size == 2 and mesh.axis == "h" and mesh.local(0) == [0, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh((torch.device("cuda"),) * 2)


# ---------------------------------------------------------------------------
# hop sharding


@pytest.mark.parametrize("shards", [2, 8])
def test_hop_sharded_sweep_exact(shards):
    """tests/test_parallel.py:264-277: avg at rtol 1e-6, samples exact,
    against the port's unsharded step and the JAX sharded sweep; no
    exchange between shards, and the accumulators stay split."""
    cfg = powerscan.PowerConfig(bin_e=6, downsample=1, buf_len=512)
    jcfg = jpowerscan.PowerConfig(bin_e=6, downsample=1, buf_len=512)
    h = 8
    rng = np.random.default_rng(2)
    blocks = rng.integers(-3000, 3000, (h, cfg.buf_len)).astype(np.int16)
    before = EXCHANGES.copy()
    acc = powerscan.new_sweep_accum(h, cfg, "cpu")
    mesh = _cpu_mesh(shards, "h")
    for _ in range(2):
        acc = hop_sharded_sweep(cfg, acc, blocks, mesh)
    assert len(acc.parts) == shards
    assert EXCHANGES == before
    acc_u = powerscan.new_sweep_accum(h, cfg, "cpu")
    for _ in range(2):
        acc_u = powerscan.sweep_step(cfg, acc_u, blocks)
    jacc = jpowerscan.new_sweep_accum(h, jcfg)
    for _ in range(2):
        jacc = jpar.hop_sharded_sweep(jcfg, jacc, blocks,
                                      jpar.make_mesh(8, axis="h"))
    for want_avg, want_samples in ((acc_u.avg.numpy(), acc_u.samples),
                                   (np.asarray(jacc.avg), jacc.samples)):
        np.testing.assert_allclose(acc.avg.numpy(), want_avg, rtol=1e-6)
        np.testing.assert_array_equal(acc.samples.numpy(),
                                      np.asarray(want_samples))


def test_int_hop_sharded_exact():
    """``--int-fft`` hop sharding is bit-exact against the unsharded
    integer scanner and the JAX sharded one."""
    cfg = powerscan.PowerConfig(bin_e=6, downsample=2, buf_len=1024)
    jcfg = jpowerscan.PowerConfig(bin_e=6, downsample=2, buf_len=1024)
    rng = np.random.default_rng(5)
    blocks = rng.integers(-32768, 32767, (8, cfg.buf_len)).astype(np.int16)
    before = EXCHANGES.copy()
    got = int_hop_sharded(cfg, blocks, _cpu_mesh(4, "h")).numpy()
    assert EXCHANGES == before
    np.testing.assert_array_equal(
        got, powerscan.int_sweep_powers(cfg, blocks, "cpu").numpy())
    from rx_tools_tpu.parallel.hopshard import int_hop_sharded as jint
    np.testing.assert_array_equal(
        got, np.asarray(jint(jcfg, blocks, jpar.make_mesh(8, axis="h"))))


# ---------------------------------------------------------------------------
# channel sharding


def _pfb_cfgs():
    kw = dict(capture_rate=1_024_000, n_channels=16, mode="fm",
              custom_atan=1, deemph_a=7, rate_out2=32_000)
    return pfb.PfbConfig(**kw), jpfb.PfbConfig(**kw)


@pytest.mark.parametrize("shards", [2, 8])
def test_channel_sharded_pfb_bit_exact(shards):
    """tests/test_parallel.py:225-245: the channel axis sharded while
    streaming 3 blocks is bit-identical to the single-device step — audio,
    counts and every state leaf — and makes no exchange."""
    cfg, _ = _pfb_cfgs()
    n = pfb.block_samples(cfg, target=4096)
    mesh = _cpu_mesh(shards, "c")
    rng = np.random.default_rng(11)
    st_u, st_s = pfb.init_state(cfg, "cpu"), pfb.init_state(cfg, "cpu")
    before = EXCHANGES.copy()
    for b in range(3):
        blk = rng.integers(-3000, 3000, 2 * n).astype(np.int16)
        st_u, a_u, nv_u = pfb.pfb_step(cfg, st_u, blk)
        st_s, a_s, nv_s = channel_sharded_pfb_step(cfg, st_s, blk, mesh)
        assert torch.equal(a_u, a_s), f"block {b}"
        assert torch.equal(nv_u, nv_s)
    assert EXCHANGES == before
    from rx_tools_tpu_torch.stream.checkpoint import tree_leaves
    for lu, ls in zip(tree_leaves(st_u), tree_leaves(st_s)):
        assert torch.equal(lu, ls)


def test_channel_sharded_pfb_matches_reference():
    """Against the JAX sharded step on a channel that holds an FM carrier,
    at the PFB tests' bound (tests/test_pfb.py:174-176), restricted to a
    channel range as a process of a multi-process job runs it."""
    cfg, jcfg = _pfb_cfgs()
    n = pfb.block_samples(cfg, target=4096)
    lo, hi = 0, 8
    full, jfull = pfb.init_state(cfg, "cpu"), jpfb.init_state(jcfg)

    def part(st, cut):
        return type(st)(tail=st.tail, prev_iq=cut(st.prev_iq),
                        deemph_avg=cut(st.deemph_avg),
                        resamp=type(st.resamp)(cut(st.resamp.acc),
                                               cut(st.resamp.phase)))

    st = part(full, lambda x: x[lo:hi])
    jst = part(jfull, lambda x: x[lo:hi])
    t = np.arange(n)
    for b in range(3):
        tt = t + b * n
        audio = np.sin(2 * np.pi * 700 * tt / cfg.capture_rate)
        z = 90 * np.exp(1j * (2 * np.pi * 3 * tt / 16 + 2 * np.pi * 15e3
                              * np.cumsum(audio) / cfg.capture_rate))
        blk = np.empty(2 * n, np.int16)
        blk[0::2] = np.round(z.real * 256)
        blk[1::2] = np.round(z.imag * 256)
        st, a, nv = channel_sharded_pfb_step(cfg, st, blk,
                                             _cpu_mesh(4, "c"),
                                             channels=(lo, hi))
        jst, ja, jnv = jpar.channel_sharded_pfb_step(
            jcfg, jst, jnp.asarray(blk), jpar.make_mesh(4, axis="c"),
            channels=(lo, hi))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        want = np.asarray(ja, np.float64)[3]        # the carrier's channel
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(a.numpy()[3] / scale, want / scale,
                                   rtol=2e-4, atol=2e-4)
        assert a.shape == ja.shape
    jax.block_until_ready(ja)
