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
    dict(dc_block_raw=True),                          # stateful heads:
    dict(downsample_passes=1, downsample=2),          # per-block loop
    dict(fir_quality=24),
    dict(resample_quality=16),
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
    dict(mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
         downsample=6, custom_atan=1, deemph_a=7, dc_block_raw=True),
    dict(mode="am", rate_in=24000, rate_out=24000, rate_out2=-1,
         downsample=6, output_scale=2, dc_block_raw=True,
         offset_tuning=True),
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


def _step_vs_reference(cfg, blocks):
    """Step both chains block by block: same counts, audio at stage
    tolerance, PCM within 1 LSB, levels and state at stage tolerance."""
    rcfg = ref_chain.FmConfig(**dataclasses.asdict(cfg))
    st = fmchain.init_state(cfg, "cpu")
    rst = ref_chain.init_state(rcfg)
    for b in blocks:
        st, a, nv, lv = fmchain.fm_chain_step(cfg, st, b)
        rst, ra, rnv, rlv = ref_chain.fm_chain_step(rcfg, rst, b)
        assert int(nv) == int(rnv)
        np.testing.assert_allclose(a.numpy(), np.asarray(ra), **STAGE)
        pcm = fmchain.audio_to_int16(a.numpy()[: int(nv)]).astype(int)
        assert np.abs(pcm - ref_chain.audio_to_int16(
            np.asarray(ra)[: int(rnv)])).max(initial=0) <= 1
        assert float(lv) == pytest.approx(float(rlv), rel=1e-4)
    for got, want in zip(_leaves(st), _ref_leaves(rst)):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **STAGE)


@pytest.mark.parametrize("kw", [dict(dc_block_raw=True),
                                dict(downsample_passes=2, downsample=4,
                                     comp_fir_size=9),
                                dict(fir_quality=64),
                                dict(resample_quality=32)],
                         ids=["rdc", "fifth-droop", "polyfir", "sinc"])
def test_stateful_heads_match_reference(kw):
    """Each head off the boxcar path, and the sinc resampler, against the
    reference chain at tests/test_fmchunk.py:43's bound."""
    cfg = dataclasses.replace(_wbfm(), **kw)
    _step_vs_reference(cfg, _blocks(cfg, 4, seed=2, amp=8000))


def _planned(**kw):
    cfg, _, _ = fmchain.plan_capture(fmchain.FmConfig(**kw), 100e6)
    return cfg


BASELINE = {
    # BASELINE config #2: -M nbfm -s 96k -r 48k -F 9 -l 10 (D = 16, 4 passes)
    "config2": _planned(mode="fm", rate_in=96000, rate_out=96000,
                        rate_out2=48000, downsample_passes=1,
                        comp_fir_size=9, squelch_level=10.0),
    # BASELINE config #3: -M am -s 24k -E dc -E offset (D = 42), and -E rdc
    "config3": _planned(mode="am", rate_in=24000, rate_out=24000,
                        dc_block_audio=True, offset_tuning=True),
    "config3-rdc": _planned(mode="am", rate_in=24000, rate_out=24000,
                            dc_block_audio=True, offset_tuning=True,
                            dc_block_raw=True),
    # -E hq at the wbfm preset: polyphase FIR (64 taps) + sinc (32 taps)
    "wbfm-hq": dataclasses.replace(_planned(
        mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
        custom_atan=1, deemph_a=13), fir_quality=64, resample_quality=32),
}


@pytest.mark.parametrize("name", list(BASELINE))
def test_baseline_configs_match_reference(name):
    cfg = BASELINE[name]
    assert cfg.downsample == {"config2": 16, "wbfm-hq": 6}.get(name, 42)
    _step_vs_reference(cfg, _blocks(cfg, 4, seed=4, amp=12000, target=None))


@pytest.mark.parametrize("name", list(BASELINE))
def test_scan_engine_bit_identical_for_stateful_heads(name):
    """The scan engine keeps per-block carries for the stateful heads: its
    output equals stepping bit for bit."""
    cfg = BASELINE[name]
    _scan_vs_stepping(cfg, _blocks(cfg, 4, seed=5, target=None))


def test_entry_twin_runs_the_wbfm_step():
    from rx_tools_tpu_torch import entry
    fn, (state, block) = entry.entry("cpu")
    st, audio, nv, lv = fn(state, block)
    want = fmchain.fm_chain_step(_wbfm(), fmchain.init_state(_wbfm(), "cpu"),
                                 block)
    assert int(nv) == int(want[2]) > 0
    assert torch.equal(audio, want[1])
    assert state.prev_iq.device.type == "cpu"
