"""The port's polyphase filterbank channelizer against the reference
package's, on the same seeded blocks (tests/test_pfb.py's geometry and
bounds): both engines with their carried state, the filterbank forms,
channel mapping, the seam, the matrices, and raw mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu.models import pfb as jpfb
from rx_tools_tpu_torch.models import convert, pfb

torch.set_num_threads(2)

FS = 1_024_000
D = 16
PFB_TOL = (2e-4, 2e-4)             # tests/test_pfb.py:174-176
FUZZ_TOL = (2e-3, 6e-3)            # tests/test_pfb.py:257-259


def _cfgs(mode="raw", **kw):
    kw = dict(capture_rate=FS, n_channels=D, taps_per_branch=8, mode=mode,
              **kw)
    return pfb.PfbConfig(**kw), jpfb.PfbConfig(**kw)


def _tone_block(n, f, amp=100.0, fm_audio=None, deviation=75e3, seed=0,
                noise=0.01):
    """tests/test_pfb.py:21-36's block."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if fm_audio is None:
        z = amp * np.exp(2j * np.pi * f * t / FS)
    else:
        audio = np.sin(2 * np.pi * fm_audio * t / FS)
        z = amp * np.exp(1j * (2 * np.pi * (f * t / FS)
                               + 2 * np.pi * deviation * np.cumsum(audio)
                               / FS))
    z = z + rng.normal(0, noise, n) + 1j * rng.normal(0, noise, n)
    blk = np.empty(2 * n, np.int16)
    blk[0::2] = np.round(np.real(z) * 256)
    blk[1::2] = np.round(np.imag(z) * 256)
    return blk


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, rtol=tol[0], atol=tol[1],
                               err_msg=what)


def _state_close(port_state, ref_state, tol, what):
    got = convert.state_to_numpy(port_state)
    for name, w in jax.device_get(ref_state)._asdict().items():
        pairs = ([(f"{name}.{k}", got[name][k], v)
                  for k, v in w._asdict().items()]
                 if isinstance(got[name], dict) else [(name, got[name], w)])
        for key, g, v in pairs:
            v = np.asarray(v)
            assert g.dtype == v.dtype and g.shape == v.shape, key
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(g, v, err_msg=f"{what} {key}")
            else:
                _close(g, v, tol, f"{what} {key}")


ENGINE_KW = [
    dict(mode="fm", custom_atan=1, deemph_a=7, rate_out2=32000),
    dict(mode="fm", custom_atan=0),
    dict(mode="fm", custom_atan=3, deemph_a=7),
    dict(mode="am", rate_out2=32000),
    dict(mode="usb"),
]


@pytest.mark.parametrize("engine", ["tmaj", "cm"])
@pytest.mark.parametrize("kw", ENGINE_KW, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_engine_matches_reference(engine, kw):
    """Each engine against its reference twin over 3 chained blocks and the
    carried state after each (through models/convert.py): the resampler
    phase exact, floats at tests/test_pfb.py:174's bound."""
    cfg, jcfg = _cfgs(**kw)
    n = pfb.block_samples(cfg, target=4096)
    assert (n // D) % 128 == 0
    if engine == "tmaj":
        st, jst = pfb.init_state_tmaj(cfg, "cpu"), jpfb.init_state_tmaj(jcfg)
        step, jstep = pfb.pfb_step_tmaj, jpfb.pfb_step_tmaj
    else:
        st, jst = pfb.init_state(cfg, "cpu"), jpfb.init_state(jcfg)
        step, jstep = pfb.pfb_step, jpfb.pfb_step
    for b in range(3):
        blk = _tone_block(n, 3.3 * FS / D, amp=90, fm_audio=700, seed=10 + b,
                          noise=0.5)
        st, a, nv = step(cfg, st, blk)
        jst, ja, jnv = jstep(jcfg, jst, jnp.asarray(blk))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        assert a.shape == ja.shape
        _close(a.numpy(), ja, PFB_TOL, f"{engine} block {b}")
        _state_close(st, jst, PFB_TOL, f"{engine} block {b}")


@pytest.mark.parametrize("kw", ENGINE_KW[:2] + ENGINE_KW[3:4],
                         ids=["fm-deemph-rs", "fm-std", "am"])
def test_tmaj_matches_channel_major(kw):
    """Inside the port: the time-major engine == the channel-major one
    (audio transposed), tests/test_pfb.py:145-176."""
    cfg, _ = _cfgs(**kw)
    n = pfb.block_samples(cfg, target=4096)
    st_cm, st_tm = pfb.init_state(cfg, "cpu"), pfb.init_state_tmaj(cfg, "cpu")
    for b in range(3):
        blk = _tone_block(n, 3.3 * FS / D, amp=90, fm_audio=700, seed=10 + b,
                          noise=0.5)
        st_cm, a_cm, nv_cm = pfb.pfb_step(cfg, st_cm, blk)
        st_tm, a_tm, nv_tm = pfb.pfb_step_tmaj(cfg, st_tm, blk)
        assert int(nv_cm[0]) == int(nv_tm)
        k = int(nv_tm)
        _close(a_tm.numpy().T[:, :k], a_cm.numpy()[:, :k], PFB_TOL,
               f"block {b}")


def test_state_carries_across_packages():
    """Reference states fetched with jax.device_get continue in the port
    (both engines), and the port's own states round-trip losslessly."""
    cfg, jcfg = _cfgs(mode="fm", custom_atan=1, deemph_a=7, rate_out2=32000)
    n = pfb.block_samples(cfg, target=4096)
    b0, b1 = (_tone_block(n, 3.3 * FS / D, amp=90, fm_audio=700, seed=s,
                          noise=0.5) for s in (1, 2))
    for init, jinit, step, jstep, conv in (
            (pfb.init_state_tmaj, jpfb.init_state_tmaj, pfb.pfb_step_tmaj,
             jpfb.pfb_step_tmaj, convert.pfb_state_tm_from_numpy),
            (pfb.init_state, jpfb.init_state, pfb.pfb_step, jpfb.pfb_step,
             convert.pfb_state_from_numpy)):
        jst, _, _ = jstep(jcfg, jinit(jcfg), jnp.asarray(b0))
        st = conv(jax.device_get(jst), "cpu")
        assert st.resamp.phase.dtype == torch.int32
        again = conv(convert.state_to_numpy(st), "cpu")
        for x, y in zip(jax.tree_util.tree_leaves(tuple(st)),
                        jax.tree_util.tree_leaves(tuple(again))):
            assert torch.equal(x, y)
        st, a, _ = step(cfg, st, b1)
        jst, ja, _ = jstep(jcfg, jst, jnp.asarray(b1))
        _close(a.numpy(), ja, PFB_TOL, init.__name__)
        _state_close(st, jst, PFB_TOL, init.__name__)


def test_fuzz_engines_against_each_other_and_reference():
    """tests/test_pfb.py:225-259's differential fuzz, trimmed: random
    configs through the port's two engines and the reference's time-major
    one, rtol 2e-3 / atol 6e-3."""
    rng = np.random.default_rng(99)
    done = 0
    for trial in range(10):
        d_ch = int(rng.choice([8, 16, 32]))
        mode = str(rng.choice(["fm", "fm", "am", "usb"]))
        kw = dict(capture_rate=FS, n_channels=d_ch,
                  taps_per_branch=int(rng.choice([4, 8])), mode=mode,
                  custom_atan=int(rng.choice([0, 1, 3])) if mode == "fm"
                  else 0,
                  deemph_a=int(rng.choice([0, 7])) if mode == "fm" else 0,
                  rate_out2=int(rng.choice([-1, 32000])))
        cfg, jcfg = pfb.PfbConfig(**kw), jpfb.PfbConfig(**kw)
        n = pfb.block_samples(cfg, target=16384)
        k_on = int(rng.integers(0, d_ch))
        if (n // d_ch) % 128 or done >= 4:
            continue
        done += 1
        blk0 = _tone_block(2 * n, (k_on if k_on < d_ch / 2 else k_on - d_ch)
                           * FS / d_ch, amp=80, fm_audio=700, seed=trial,
                           noise=0.4)
        st_cm, st_tm = pfb.init_state(cfg, "cpu"), pfb.init_state_tmaj(cfg,
                                                                        "cpu")
        jst = jpfb.init_state_tmaj(jcfg)
        for b in range(2):
            blk = blk0[b * 2 * n: (b + 1) * 2 * n]
            st_cm, a_cm, nv_cm = pfb.pfb_step(cfg, st_cm, blk)
            st_tm, a_tm, nv_tm = pfb.pfb_step_tmaj(cfg, st_tm, blk)
            jst, ja, jnv = jpfb.pfb_step_tmaj(jcfg, jst, jnp.asarray(blk))
            assert int(nv_cm[0]) == int(nv_tm) == int(jnv), (trial, b)
            k = int(nv_tm)
            _close(a_tm.numpy().T[:, :k], a_cm.numpy()[:, :k], FUZZ_TOL,
                   f"{trial} {b}")
            _close(a_tm.numpy(), ja, FUZZ_TOL, f"{trial} {b} vs reference")
    assert done == 4


@pytest.mark.parametrize("k", [0, 1, 5, 8, 13])
def test_channel_mapping_and_rejection(k):
    """A tone at channel k's centre lands in channel k, every other channel
    at least 40 dB down (tests/test_pfb.py:39-53), and the port's
    filterbank equals the reference's at the PFB bound."""
    cfg, jcfg = _cfgs()
    n = pfb.block_samples(cfg, target=32768)
    blk = _tone_block(n, cfg.channel_freqs()[k])
    tail0 = pfb.init_state(cfg, "cpu").tail
    _, zi, zq = pfb.filterbank(cfg, tail0, blk)
    e = (zi ** 2 + zq ** 2).sum(dim=1).numpy()
    assert np.argmax(e) == k
    assert 10 * np.log10(np.delete(e, k).max() / e[k]) < -40
    _, ji, jq = jpfb.filterbank(jcfg, jpfb.init_state(jcfg).tail,
                                jnp.asarray(blk))
    _close(zi.numpy(), ji, PFB_TOL, "zi")
    _close(zq.numpy(), jq, PFB_TOL, "zq")


def test_streaming_seam_bit_exact():
    """Two half blocks through the carried tail == one full block, bit for
    bit, in each filterbank form (tests/test_pfb.py:55-70)."""
    cfg, _ = _cfgs()
    n = pfb.block_samples(cfg, target=32768)
    blk = np.random.default_rng(1).integers(-8000, 8000, 2 * n).astype(
        np.int16)
    st0 = pfb.init_state(cfg, "cpu").tail
    for fb in (pfb.filterbank, pfb.filterbank_mxu):
        _, fi, fq = fb(cfg, st0, blk)
        t1, h1i, h1q = fb(cfg, st0, blk[:n])
        _, h2i, h2q = fb(cfg, t1, blk[n:])
        assert torch.equal(torch.cat([h1i, h2i], dim=1), fi), fb.__name__
        assert torch.equal(torch.cat([h1q, h2q], dim=1), fq), fb.__name__
    tx = pfb.init_state_tmaj(cfg, "cpu").tailx
    _, full = pfb.filterbank_tmaj(cfg, tx, blk)
    t1, h1 = pfb.filterbank_tmaj(cfg, tx, blk[:n])
    _, h2 = pfb.filterbank_tmaj(cfg, t1, blk[n:])
    assert torch.equal(torch.cat([h1, h2[1:]]), full)


def test_filterbank_forms_agree():
    """filterbank (FIR + FFT) == filterbank_mxu (FIR + DFT product) ==
    filterbank_tmaj transposed, and each the reference's."""
    cfg, jcfg = _cfgs()
    n = pfb.block_samples(cfg, target=32768)
    blk = np.random.default_rng(3).integers(-8000, 8000, 2 * n).astype(
        np.int16)
    tail0 = pfb.init_state(cfg, "cpu").tail
    _, fi, fq = pfb.filterbank(cfg, tail0, blk)
    _, mi, mq = pfb.filterbank_mxu(cfg, tail0, blk)
    _, t2 = pfb.filterbank_tmaj(cfg, pfb.init_state_tmaj(cfg, "cpu").tailx,
                                blk)
    _close(mi.numpy(), fi.numpy(), PFB_TOL, "mxu zi")
    _close(mq.numpy(), fq.numpy(), PFB_TOL, "mxu zq")
    _close(t2[1:, :D].numpy().T, mi.numpy(), PFB_TOL, "tmaj re")
    _close(t2[1:, D:].numpy().T, mq.numpy(), PFB_TOL, "tmaj im")
    _, ji, jq = jpfb.filterbank_mxu(jcfg, jpfb.init_state(jcfg).tail,
                                    jnp.asarray(blk))
    _close(mi.numpy(), ji, PFB_TOL, "vs reference mxu")
    _close(mq.numpy(), jq, PFB_TOL, "vs reference mxu")


@pytest.mark.parametrize("d,taps", [(16, 8), (64, 8), (8, 4)])
def test_derived_matrices_bitwise(d, taps):
    """The prototype, the DFT matrix and the branch taps derive from the
    config, bit for bit the reference's (np.float32)."""
    cfg = pfb.PfbConfig(capture_rate=2_400_000, n_channels=d,
                        taps_per_branch=taps)
    jcfg = jpfb.PfbConfig(capture_rate=2_400_000, n_channels=d,
                          taps_per_branch=taps)
    h = pfb._prototype(cfg)
    assert h.dtype == np.float32
    np.testing.assert_array_equal(h, jpfb._prototype(jcfg))
    np.testing.assert_array_equal(pfb._dft_matrix(d), jpfb._dft_matrix(d))
    hp2 = np.asarray(jpfb._prototype(jcfg)).reshape(taps, d)[::-1, ::-1]
    np.testing.assert_array_equal(pfb._branch_taps(taps, d, 8.6),
                                  np.repeat(hp2, 2, axis=1)[::-1])
    assert cfg.channel_freqs(98e6) == jcfg.channel_freqs(98e6)


def test_raw_stays_on_channel_major():
    """Raw mode: the time-major step refuses it (the reference returns a
    packed [Re | Im] matrix there, ADVICE.md:4); the channel-major step
    gives per-channel interleaved I/Q equal to the reference's."""
    cfg, jcfg = _cfgs(mode="raw")
    n = pfb.block_samples(cfg, target=4096)
    blk = _tone_block(n, 2.0 * FS / D, amp=80, seed=4)
    with pytest.raises(ValueError, match="raw"):
        pfb.pfb_step_tmaj(cfg, pfb.init_state_tmaj(cfg, "cpu"), blk)
    st, jst = pfb.init_state(cfg, "cpu"), jpfb.init_state(jcfg)
    for b in range(2):
        st, a, nv = pfb.pfb_step(cfg, st, blk)
        jst, ja, jnv = jpfb.pfb_step(jcfg, jst, jnp.asarray(blk))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-3)
    # the reference's tmaj raw packing, for the record: (M, 2D) [Re | Im]
    _, jtm, _ = jpfb.pfb_step_tmaj(jcfg, jpfb.init_state_tmaj(jcfg),
                                   jnp.asarray(blk))
    assert np.asarray(jtm).shape == (n // D, 2 * D)


def test_tmaj_block_guard():
    cfg, _ = _cfgs(mode="fm", deemph_a=7)
    with pytest.raises(ValueError, match="divisible by 128"):
        pfb.pfb_step_tmaj(cfg, pfb.init_state_tmaj(cfg, "cpu"),
                          np.zeros(2 * D * 100, np.int16))


def test_fm_demod_through_channel():
    """A WBFM station at channel 3's centre: pfb_step recovers its 1 kHz
    tone there and not 4 channels away (tests/test_pfb.py:73-101)."""
    cfg, _ = _cfgs(mode="fm", custom_atan=0, deemph_a=0, rate_out2=32000)
    n = pfb.block_samples(cfg, target=131072)
    blk = _tone_block(n, cfg.channel_freqs()[3], fm_audio=1000.0,
                      deviation=20e3, noise=1.0)
    _, audio, n_valid = pfb.pfb_step(cfg, pfb.init_state(cfg, "cpu"), blk)

    def prominence(ch):
        a = audio[ch, : int(n_valid[ch])].numpy().astype(np.float64)
        a = a[len(a) // 4:]
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = np.fft.rfftfreq(a.size, 1 / 32000.0)[np.argmax(spec[1:]) + 1]
        return peak, spec.max() / np.mean(spec)

    peak, prom = prominence(3)
    assert abs(peak - 1000.0) < 30 and prom > 50, (peak, prom)
    assert prominence(7)[1] < prom / 5
