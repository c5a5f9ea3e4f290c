"""The port's ChunkedFmRunner: squelch semantics (skip / -E zero /
exit-on-squelch / hop, rtl_fm.c:916-946) as in tests/test_chunked.py, the
same output as the reference runner, and the flat engine (and fused
front) against the default engine, partial tail chunk included."""

import numpy as np
import pytest
import torch

from rx_tools_tpu.models import fmchain as ref_chain
from rx_tools_tpu.stream.chunked import ChunkedFmRunner as RefRunner
from rx_tools_tpu_torch.iq.sources import make_source
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner

torch.set_num_threads(2)


def _kw(**kw):
    base = dict(mode="fm", rate_in=96000, rate_out=96000, rate_out2=-1,
                downsample=4, custom_atan=1)
    base.update(kw)
    return base


class SceneSource:
    """Quiet blocks, then loud FM, then quiet again (tests/test_chunked.py:
    the emitter sits at -fs/4 + 2% so the derotation lands it at a low IF
    that the DC-corrected squelch RMS sees)."""

    def __init__(self, pattern):
        self.pattern = pattern   # "loud"/"quiet" per block
        self.i = 0
        self._n0 = 0
        self.rng = np.random.default_rng(0)

    def read_stream(self, k):
        if self.i >= len(self.pattern):
            return 0, np.empty(0, np.int16)
        amp = 20000 if self.pattern[self.i] == "loud" else 20
        self.i += 1
        t = np.arange(self._n0, self._n0 + k)
        self._n0 += k
        w = 2 * np.pi * (-0.25 + 0.02)
        z = amp * np.exp(1j * (w * t + 0.3 * np.sin(2 * np.pi * 0.01 * t)))
        iq = np.empty(2 * k, np.int16)
        iq[0::2] = np.round(np.real(z))
        iq[1::2] = np.round(np.imag(z)) + self.rng.integers(-3, 3, k)
        return k, iq

    def set_frequency(self, f):
        return 0


def _run(cfg, pattern, runner=ChunkedFmRunner, chunk=2, **kw):
    n = fmchain.block_samples(fmchain.FmConfig(**cfg), target=256)
    if runner is ChunkedFmRunner:
        kw["device"] = "cpu"
        config = fmchain.FmConfig(**cfg)
    else:
        config = ref_chain.FmConfig(**cfg)
    got = []
    r = runner(config, SceneSource(pattern), lambda a, lvl: got.append(a),
               chunk=chunk, block_size=n, **kw)
    stats = r.run()
    return got, stats, r


def test_squelch_skip_single_freq():
    got, stats, _ = _run(_kw(squelch_level=100.0, conseq_squelch=2),
                         ["quiet"] * 8 + ["loud"] * 4)
    assert stats.blocks == 12
    assert len(got) == 4              # starts muted: quiet blocks skipped


def test_squelch_zero_emits():
    got, _, _ = _run(_kw(squelch_level=100.0, conseq_squelch=2,
                         squelch_zero=True), ["quiet"] * 6 + ["loud"] * 2)
    assert len(got) == 8
    assert np.sqrt(np.mean(np.concatenate(got[:6]) ** 2)) < 1.0


def test_exit_on_squelch():
    pattern = ["loud"] * 4 + ["quiet"] * 20
    _, stats, r = _run(_kw(squelch_level=100.0, conseq_squelch=2), pattern,
                       exit_on_squelch=True)
    assert r._stop and stats.blocks < len(pattern)


def test_hop_on_squelch():
    hops = []
    got, _, _ = _run(_kw(squelch_level=100.0, conseq_squelch=1),
                     ["quiet"] * 10, on_squelch=lambda: hops.append(1) or True)
    assert len(hops) >= 4 and got == []


@pytest.mark.parametrize("kw", [_kw(),
                                _kw(squelch_level=100.0, conseq_squelch=2)])
def test_runner_matches_reference_runner(kw):
    pattern = ["quiet"] * 3 + ["loud"] * 4
    got, stats, _ = _run(kw, pattern, chunk=3)
    want, rstats, _ = _run(kw, pattern, runner=RefRunner, chunk=3)
    assert len(got) == len(want)
    assert stats.samples_out == rstats.samples_out
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=0.02)


@pytest.mark.parametrize("fused", [None, True])
def test_flat_engine_runner_matches_default(fused):
    """engine="flat": whole-chunk programs, per-chunk emit; a partial tail
    chunk falls back to the scan engine on the interoperable state."""
    cfg = fmchain.FmConfig(mode="fm", rate_in=170000, rate_out=170000,
                           rate_out2=32000, downsample=6, custom_atan=1,
                           deemph_a=13, squelch_level=0.0)
    n = fmchain.block_samples(cfg, target=2016)

    def run(engine):
        src = make_source("synth=fm,det=1,seed=9,audio=1k,dev=50k,amp=0.6")
        src.set_sample_rate(170000 * 6)
        src.set_frequency(100e6)
        out = []
        r = ChunkedFmRunner(cfg, src, lambda a, lvl: out.append(a.copy()),
                            chunk=4, block_size=n, engine=engine,
                            fused=fused, device="cpu")
        r.run(max_blocks=11)          # 2 full chunks + a 3-block tail
        return np.concatenate(out), r.stats

    a0, s0 = run("scan")
    a1, s1 = run("flat")
    assert s0.blocks == s1.blocks == 11
    assert a0.shape == a1.shape
    np.testing.assert_allclose(a1, a0, rtol=1e-4, atol=0.05)
