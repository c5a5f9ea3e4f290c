"""The port's chain, engines and state carry against the reference package
on the CPU, and the port's scan engine against its own per-block stepping
(bit for bit, mirroring tests/test_stream.py:57-138)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu.models import fmchain as ref_chain
from rx_tools_tpu.models import fmchunk as ref_chunk
from rx_tools_tpu.stream import scan as ref_scan
from rx_tools_tpu_torch.models import convert, fmchain, fmchunk
from rx_tools_tpu_torch.ops import filters, resample
from rx_tools_tpu_torch.stream import scan

torch.set_num_threads(2)

# stage tolerance of tests/test_fmchunk.py:43
STAGE = dict(rtol=1e-4, atol=0.02)


def _blocks(cfg, m, seed=0, amp=2000, target=480):
    n = fmchain.block_samples(cfg, target=target)
    rng = np.random.default_rng(seed)
    return rng.integers(-amp, amp, (m, 2 * n)).astype(np.int16)


def _wbfm():
    cfg, _, _ = fmchain.plan_capture(fmchain.wbfm_preset(), 100.3e6)
    return cfg


def _flat(nest):
    """Leaves of a state nest (dicts or NamedTuples of arrays) in FmState
    field order."""
    if hasattr(nest, "_asdict"):
        nest = nest._asdict()
    if isinstance(nest, dict):
        return [leaf for v in nest.values() for leaf in _flat(v)]
    return [np.asarray(nest)]


def _leaves(state):
    """The port's state as numpy leaves in field order."""
    return _flat(convert.fm_state_to_numpy(state))


def _ref_leaves(state):
    return _flat(jax.device_get(state))


def test_config_and_state_fields_match_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(fmchain.FmConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_chain.FmConfig)]
    assert got == want
    assert fmchain.FmState._fields == ref_chain.FmState._fields
    assert _wbfm() == fmchain.FmConfig(
        **dataclasses.asdict(ref_chain.plan_capture(
            ref_chain.wbfm_preset(), 100.3e6)[0]))
    for target in (None, 480, 258048):
        cfg = _wbfm()
        rcfg = ref_chain.FmConfig(**dataclasses.asdict(cfg))
        assert (fmchain.block_samples(cfg, target)
                == ref_chain.block_samples(rcfg, target))
    st = fmchain.init_state(_wbfm(), "cpu")
    ref = jax.device_get(ref_chain.init_state(ref_chain.FmConfig(
        **dataclasses.asdict(_wbfm()))))
    for got_leaf, want_leaf in zip(_leaves(st), _flat(ref)):
        assert got_leaf.shape == want_leaf.shape
        assert got_leaf.dtype == want_leaf.dtype
        np.testing.assert_array_equal(got_leaf, want_leaf)


def test_chain_step_matches_reference():
    """A few wbfm blocks: audio at stage tolerance, PCM within 1 LSB with
    the same count, state at stage tolerance."""
    cfg = _wbfm()
    rcfg = ref_chain.FmConfig(**dataclasses.asdict(cfg))
    blocks = _blocks(cfg, 4, seed=1, amp=8000)
    st = fmchain.init_state(cfg, "cpu")
    rst = ref_chain.init_state(rcfg)
    for b in blocks:
        st, a, nv, lv = fmchain.fm_chain_step(cfg, st, b)
        rst, ra, rnv, rlv = ref_chain.fm_chain_step(rcfg, rst, b)
        assert int(nv) == int(rnv)
        np.testing.assert_allclose(a.numpy(), np.asarray(ra), **STAGE)
        pcm = fmchain.audio_to_int16(a.numpy()[: int(nv)]).astype(int)
        rpcm = ref_chain.audio_to_int16(np.asarray(ra)[: int(rnv)])
        assert np.abs(pcm - rpcm).max() <= 1
        assert float(lv) == pytest.approx(float(rlv), rel=1e-4)
    for got, want in zip(_leaves(st), _ref_leaves(rst)):
        np.testing.assert_allclose(got, want, **STAGE)


SCAN_CASES = [
    dict(),                                           # wbfm-like default
    dict(custom_atan=0), dict(custom_atan=2), dict(custom_atan=3),
    dict(mode="am", deemph_a=0), dict(mode="usb", deemph_a=0),
    dict(mode="lsb", deemph_a=0, rate_out2=-1),
    dict(mode="raw", deemph_a=0, rate_out2=-1),
    dict(dc_block_audio=True),
    dict(post_downsample=2, rate_out2=-1, deemph_a=0),
    dict(offset_tuning=True),
    dict(squelch_level=30.0),                         # per-block loop
    dict(fused=True),                                 # per-block loop
]


def _scan_vs_stepping(cfg, blocks, fused=None):
    st_s, audio_s, nv_s, lv_s = scan.scan_fm_blocks(
        cfg, fmchain.init_state(cfg, "cpu"), blocks, fused=fused)
    st2 = fmchain.init_state(cfg, "cpu")
    outs, nvs, lvs = [], [], []
    for b in blocks:
        st2, a, nv, lv = fmchain.fm_chain_step(cfg, st2, b, fused=fused)
        outs.append(a.numpy())
        nvs.append(int(nv))
        lvs.append(float(lv))
    np.testing.assert_array_equal(audio_s.numpy(), np.stack(outs))
    np.testing.assert_array_equal(nv_s.numpy(), np.array(nvs))
    np.testing.assert_array_equal(lv_s.numpy(), np.array(lvs, np.float32))
    for got, want in zip(_leaves(st_s), _leaves(st2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", SCAN_CASES)
def test_scan_engine_bit_identical_to_stepping(kw):
    kw = dict(kw)
    fused = kw.pop("fused", None)
    base = dict(mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
                downsample=6, custom_atan=1, deemph_a=7, squelch_level=0.0)
    base.update(kw)
    cfg = fmchain.FmConfig(**base)
    _scan_vs_stepping(cfg, _blocks(cfg, 5, seed=3), fused=fused)


def test_scan_engine_bit_identical_rows_path():
    """The CUDA tail forms (rows resampler + matmul deemph, forced on the
    CPU): the scan engine's batched per-block tail stays bit-identical."""
    cfg = fmchain.FmConfig(mode="fm", rate_in=171428, rate_out=171428,
                           rate_out2=32000, downsample=14, custom_atan=1,
                           deemph_a=7, squelch_level=0.0)
    n = fmchain.block_samples(cfg, target=14 * 1536)
    assert (n // 14) % 128 == 0
    old = (resample._ROWS_FORCE, filters._MXU_FORCE)
    resample._ROWS_FORCE = filters._MXU_FORCE = True
    try:
        _scan_vs_stepping(cfg, _blocks(cfg, 5, seed=4, target=n))
    finally:
        resample._ROWS_FORCE, filters._MXU_FORCE = old


FLAT_CONFIGS = [
    dict(mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
         downsample=6, custom_atan=1, deemph_a=7),
    dict(mode="fm", rate_in=96000, rate_out=24000, rate_out2=-1,
         downsample=10, custom_atan=0, post_downsample=4,
         dc_block_audio=True),
    dict(mode="am", rate_in=24000, rate_out=24000, rate_out2=-1,
         downsample=4, output_scale=2, offset_tuning=True),
    dict(mode="usb", rate_in=24000, rate_out=24000, rate_out2=-1,
         downsample=6),
    dict(mode="fm", rate_in=48000, rate_out=48000, rate_out2=-1,
         downsample=8, custom_atan=1, squelch_level=50.0),
]


@pytest.mark.parametrize("kw", FLAT_CONFIGS)
def test_flat_engine_matches_reference(kw):
    cfg = fmchain.FmConfig(**kw)
    rcfg = ref_chain.FmConfig(**kw)
    blocks = _blocks(cfg, 6)
    st, a, nv, lv = fmchunk.fm_chunk_step(cfg, fmchain.init_state(cfg, "cpu"),
                                          blocks)
    rst, ra, rnv, rlv = ref_chunk.fm_chunk_step(
        rcfg, ref_chain.init_state(rcfg), jnp.asarray(blocks))
    assert int(nv) == int(rnv)
    np.testing.assert_allclose(a.numpy()[: int(nv)],
                               np.asarray(ra)[: int(rnv)], **STAGE)
    np.testing.assert_allclose(lv.numpy(), np.asarray(rlv), rtol=1e-4)
    for got, want in zip(_leaves(st), _ref_leaves(rst)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_flat_then_scan_interoperate(fused):
    """The flat engine's carry feeds the scan engine; the whole stream
    matches the scan engine alone at stage tolerance (fused front too)."""
    cfg = fmchain.FmConfig(**FLAT_CONFIGS[0])
    blocks = _blocks(cfg, 8, seed=3)
    st0 = fmchain.init_state(cfg, "cpu")
    _, a_ref, nv_ref, _ = scan.scan_fm_blocks(cfg, st0, blocks)
    ref = scan.gather_valid(a_ref.numpy(), nv_ref.numpy())
    st2, a1, nv1, _ = fmchunk.fm_chunk_step(cfg, st0, blocks[:4], fused=fused)
    _, a2, nv2, _ = scan.scan_fm_blocks(cfg, st2, blocks[4:], fused=fused)
    got = np.concatenate([a1.numpy()[: int(nv1)],
                          scan.gather_valid(a2.numpy(), nv2.numpy())])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **STAGE)


def test_state_carries_across_packages():
    """convert round trip is lossless, and a reference state taken
    mid-stream continues in the port to the reference's own output."""
    cfg = _wbfm()
    rcfg = ref_chain.FmConfig(**dataclasses.asdict(cfg))
    blocks = _blocks(cfg, 6, seed=7, amp=8000)
    rst0 = ref_chain.init_state(rcfg)
    rst_mid, _, _, _ = ref_scan.scan_fm_blocks(rcfg, rst0,
                                               jnp.asarray(blocks[:3]))
    _, ra, rnv, _ = ref_scan.scan_fm_blocks(rcfg, rst_mid,
                                            jnp.asarray(blocks[3:]))
    st = convert.fm_state_from_numpy(jax.device_get(rst_mid), "cpu")
    again = convert.fm_state_from_numpy(convert.fm_state_to_numpy(st), "cpu")
    for a, b in zip(_leaves(st), _ref_leaves(rst_mid)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(again), _leaves(st)):
        np.testing.assert_array_equal(a, b)
    _, a, nv, _ = scan.scan_fm_blocks(cfg, st, blocks[3:])
    np.testing.assert_array_equal(nv.numpy(), np.asarray(rnv))
    np.testing.assert_allclose(
        scan.gather_valid(a.numpy(), nv.numpy()),
        ref_scan.gather_valid(np.asarray(ra), np.asarray(rnv)), **STAGE)


def test_unported_heads_raise():
    for kw in (dict(dc_block_raw=True), dict(downsample_passes=2),
               dict(fir_quality=64), dict(resample_quality=32)):
        cfg = dataclasses.replace(_wbfm(), **kw)
        with pytest.raises(NotImplementedError):
            fmchain.fm_chain_step(cfg, fmchain.init_state(cfg, "cpu"),
                                  _blocks(_wbfm(), 1)[0])
