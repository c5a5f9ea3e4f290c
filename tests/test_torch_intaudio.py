"""The port's --int-audio tier against the reference package's integer chain
and the C-faithful oracle, bit for bit (tests/test_intaudio.py's cases),
and its integer ops against the reference's on negative operands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu.models import fmchain as ref_chain
from rx_tools_tpu.models import fmint as ref_fmint
from rx_tools_tpu.ops import intaudio as ref_int
from rx_tools_tpu_torch.models import fmchain, fmint
from rx_tools_tpu_torch.ops import intaudio

torch.set_num_threads(2)

# tests/test_intaudio.py:52-70
CASES = [
    dict(mode="fm", custom_atan=1, deemph_a=13, rate_in=170000,
         rate_out=170000, rate_out2=32000, downsample=6),
    dict(mode="fm", custom_atan=2, deemph_a=0, dc_block_audio=True,
         rate_in=96000, rate_out=96000, rate_out2=-1, downsample=4),
    dict(mode="fm", custom_atan=3, deemph_a=7, post_downsample=4,
         rate_in=170000, rate_out=170000, rate_out2=24000, downsample=5),
    dict(mode="am", output_scale=2, rate_in=48000, rate_out=48000,
         rate_out2=-1, downsample=7),
    dict(mode="usb", output_scale=1, rate_in=24000, rate_out=24000,
         rate_out2=-1, downsample=8),
    dict(mode="lsb", output_scale=3, rate_in=24000, rate_out=24000,
         rate_out2=12000, downsample=8),
]


def _blocks(cfg, m=3, target=480, seed=0, amp=28000):
    n = fmchain.block_samples(cfg, target=target)
    rng = np.random.default_rng(seed)
    return [rng.integers(-amp, amp, 2 * n).astype(np.int16)
            for _ in range(m)]


def _oracle(cfg, blocks):
    s = c_ref.DemodState()
    for f in ("mode", "downsample", "custom_atan", "post_downsample",
              "deemph_a", "dc_block_audio", "rate_out", "rate_out2",
              "output_scale"):
        setattr(s, f, getattr(cfg, f))
    out = []
    for blk in blocks:
        lp = c_ref.rescale_cs16_to_8bit(blk)
        if not cfg.offset_tuning:
            lp = c_ref.rotate16_90(lp)
        out += c_ref.full_demod(s, lp)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c['mode']}-a{c.get('custom_atan', 0)}"
                              f"-d{c['downsample']}" for c in CASES])
def test_int_chain_bit_exact(case):
    """Port == reference package == oracle, block by block with carry."""
    cfg = fmchain.FmConfig(**case)
    rcfg = ref_chain.FmConfig(**case)
    assert fmint.supports(cfg) and ref_fmint.supports(rcfg)
    blocks = _blocks(cfg, seed=sum(map(ord, str(case))) % 1000)
    st, rst = fmint.init_state("cpu"), ref_fmint.init_state()
    got, ref = [], []
    for blk in blocks:
        st, a = fmint.int_chain_block(cfg, st, blk)
        rst, ra = ref_fmint.int_chain_block(rcfg, rst, blk)
        assert a.dtype == np.int16
        got.append(a.astype(np.int64))
        ref.append(ra.astype(np.int64))
    got, ref = np.concatenate(got), np.concatenate(ref)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(cfg, blocks))
    for a, b in zip(st, rst):
        assert int(a) == int(b)


@pytest.mark.parametrize("bad", [dict(), dict(custom_atan=0),
                                 dict(squelch_level=10.0),
                                 dict(downsample_passes=2),
                                 dict(dc_block_raw=True), dict(mode="raw"),
                                 dict(fir_quality=64),
                                 dict(resample_quality=32)])
def test_supports_agrees(bad):
    kw = dict(mode="fm", custom_atan=1, rate_in=170000, rate_out=170000,
              rate_out2=32000, downsample=6)
    kw.update(bad)
    assert (fmint.supports(fmchain.FmConfig(**kw))
            == ref_fmint.supports(ref_chain.FmConfig(**kw)))


def _x64(fn, *args):
    with jax.enable_x64(True):
        return np.asarray(fn(*[jnp.asarray(a, jnp.int64) for a in args]))


def test_integer_ops_match_reference_with_negative_operands():
    rng = np.random.default_rng(5)
    y = rng.integers(-40000, 40000, 4000)
    x = rng.integers(-40000, 40000, 4000)
    x[:4], y[:4] = (0, 0, -3, 5), (0, 7, 0, 0)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64)
    np.testing.assert_array_equal(
        intaudio._cdiv(t(y), t(np.where(x == 0, 1, x))).numpy(),
        _x64(ref_int._cdiv, y, np.where(x == 0, 1, x)))
    np.testing.assert_array_equal(intaudio.fast_atan2_int(t(y), t(x)).numpy(),
                                  _x64(ref_int.fast_atan2_int, y, x))
    np.testing.assert_array_equal(intaudio.lut_disc_int(t(x), t(y)).numpy(),
                                  _x64(ref_int.lut_disc_int, x, y))
    a = rng.integers(-300, 300, (4, 500))
    np.testing.assert_array_equal(intaudio.esbensen_int(*map(t, a)).numpy(),
                                  _x64(ref_int.esbensen_int, *a))
    np.testing.assert_array_equal(intaudio._i16(t(x * 3)).numpy(),
                                  _x64(ref_int._i16, x * 3))
    blk = rng.integers(-32768, 32767, 2 * 96).astype(np.int16)
    with jax.enable_x64(True):
        want = np.asarray(ref_int.rescale_int(jnp.asarray(blk)))
    np.testing.assert_array_equal(
        intaudio.rescale_int(torch.from_numpy(blk)).numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(c_ref.rescale_cs16_to_8bit(blk), np.int64))


@pytest.mark.parametrize("a", [13, 7, 8, 1])
def test_deemph_plain_matches_reference_scan(a):
    """The kernel's plain version == the reference's lax.scan, negative
    samples and a negative starting average included, odd and even a."""
    rng = np.random.default_rng(a)
    x = rng.integers(-32768, 32767, 700)
    for avg0 in (0, -1234, 40000):
        with jax.enable_x64(True):
            ravg, ry = ref_int.deemph_int(jnp.int64(avg0),
                                          jnp.asarray(x, jnp.int64), a)
        avg, y = intaudio.deemph_int(torch.tensor(avg0, dtype=torch.int64),
                                     torch.as_tensor(x, dtype=torch.int64),
                                     a)
        assert int(avg) == int(ravg)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    # one-sample blocks carry like one long block
    avg = torch.tensor(-77, dtype=torch.int64)
    ys = []
    for v in x[:50]:
        avg, y1 = intaudio.deemph_int(avg, torch.tensor([v]), a)
        ys.append(int(y1[0]))
    _, y_all = intaudio.deemph_int(torch.tensor(-77, dtype=torch.int64),
                                   torch.as_tensor(x[:50]), a)
    assert ys == y_all.tolist()


def test_low_pass_real_int_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.integers(-32768, 32767, 1368)
    now, ph = torch.tensor(-55, dtype=torch.int64), torch.tensor(
        3, dtype=torch.int64)
    got = intaudio.low_pass_real_int(now, ph, torch.as_tensor(x), 170000,
                                     32000)
    with jax.enable_x64(True):
        want = ref_int.low_pass_real_int(jnp.int64(-55), jnp.int64(3),
                                         jnp.asarray(x, jnp.int64),
                                         170000, 32000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))



def test_int_audio_cli_matches_oracle(tmp_path, monkeypatch):
    """The port's rx_fm --int-audio PCM equals the oracle's replay of the
    same capture bit for bit (tests/test_intaudio.py:96-134)."""
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    from rx_tools_tpu_torch.apps import rx_fm
    from rx_tools_tpu_torch.iq.sources import make_source
    src = make_source("synth=fm,audio=1k,dev=50k,amp=0.7,noise=0.01,"
                      "carrier=100.3M")
    src.set_sample_rate(1_020_000)
    src.set_frequency(100.75e6)
    cap = tmp_path / "cap.cs16"
    src.read_stream(160_000)[1].tofile(cap)
    out = tmp_path / "a.pcm"
    assert rx_fm.main(["-f", "100.3M", "-M", "wbfm", "--int-audio", "-d",
                       f"file={cap},format=CS16,rate=1020k", str(out)]) == 0
    got = np.fromfile(out, np.int16).astype(np.int64)
    cfg, _, _ = fmchain.plan_capture(fmchain.FmConfig(
        mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
        custom_atan=1, deemph_a=13), 100.3e6)
    n = fmchain.block_samples(cfg)
    iq = np.fromfile(cap, np.int16)
    blocks = [iq[i * 2 * n:(i + 1) * 2 * n] for i in range(iq.size // (2 * n))]
    want = _oracle(cfg, blocks)
    assert got.size == want.size > 3000
    np.testing.assert_array_equal(got, want)
