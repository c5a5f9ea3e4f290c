"""The port's mixer channelizer against the reference package's, on the
same seeded scenes (tests/test_channelizer.py's geometry and bounds):
both engines over chained blocks with their carried state, the engines
against each other, the differential fuzz, the matrices and the NCO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu.models import channelizer as jchan
from rx_tools_tpu_torch.models import channelizer as chan, convert

torch.set_num_threads(2)

FS = 1_024_000


def _fm_scene(n, offsets, seed, amp=40, dev=12e3, noise=0.5, gain=64):
    """An FM carrier near every station plus mild noise (the discriminator
    of near-zero noise is chaotic, tests/test_channelizer.py:93-96)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    z = np.zeros(n, np.complex128)
    for off in offsets:
        au = np.sin(2 * np.pi * (700 + off % 997) * t / FS)
        z += amp * np.exp(1j * (2 * np.pi * off * t / FS
                                + 2 * np.pi * dev * np.cumsum(au) / FS))
    z += rng.normal(0, noise, n) + 1j * rng.normal(0, noise, n)
    iq = np.empty(2 * n, np.int16)
    iq[0::2] = np.round(np.real(z) * gain)
    iq[1::2] = np.round(np.imag(z) * gain)
    return iq


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, rtol=tol[0], atol=tol[1],
                               err_msg=what)


def _state_close(port_state, ref_state, tol, what):
    """Integer leaves exact (dtype kept), float leaves at ``tol``."""
    got = convert.state_to_numpy(port_state)
    want = jax.device_get(ref_state)._asdict()
    for name, w in want.items():
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


KW = dict(capture_rate=FS, offsets=(192_000.0, -64_000.0, 17_000.0),
          downsample=16, mode="fm", custom_atan=1, deemph_a=7,
          rate_out2=32_000)
MIX_TOL = (5e-4, 5e-4)             # tests/test_channelizer.py:119
FUZZ_TOL = (2e-3, 6e-3)            # tests/test_channelizer.py:200


@pytest.mark.parametrize("engine", ["tmaj", "cm"])
def test_engine_matches_reference_over_chained_blocks(engine):
    """Each engine against its reference twin over 3 chained blocks, and
    the carried state after each block (through models/convert.py):
    integers exact (nco_num, resampler phase, sample_index), floats at the
    audio's bound."""
    cfg, jcfg = chan.ChannelizerConfig(**KW), jchan.ChannelizerConfig(**KW)
    n = chan.block_samples(cfg, target=32768)
    assert chan.tmaj_supported(cfg, n)
    iq = _fm_scene(3 * n, (192_000, -64_000, 17_000), seed=3)
    if engine == "tmaj":
        st, jst = chan.init_state_tmaj(cfg, "cpu"), jchan.init_state_tmaj(jcfg)
        step, jstep = chan.channelize_step_tmaj, jchan.channelize_step_tmaj
    else:
        st, jst = chan.init_state(cfg, "cpu"), jchan.init_state(jcfg)
        step, jstep = chan.channelize_step, jchan.channelize_step
    for b in range(3):
        blk = iq[b * 2 * n: (b + 1) * 2 * n]
        st, a, nv = step(cfg, st, blk)
        jst, ja, jnv = jstep(jcfg, jst, jnp.asarray(blk))
        assert nv.dtype == torch.int32
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        assert a.shape == ja.shape
        _close(a.numpy(), ja, MIX_TOL, f"{engine} block {b}")
        _state_close(st, jst, MIX_TOL, f"{engine} block {b}")


def test_state_carries_across_packages():
    """A reference state fetched with jax.device_get continues in the port:
    the next block's audio and state match the reference's own next block
    (the time-major engine, whose state is exact integers plus floats)."""
    cfg, jcfg = chan.ChannelizerConfig(**KW), jchan.ChannelizerConfig(**KW)
    n = chan.block_samples(cfg, target=32768)
    iq = _fm_scene(2 * n, (192_000, -64_000, 17_000), seed=4)
    jst = jchan.init_state_tmaj(jcfg)
    jst, _, _ = jchan.channelize_step_tmaj(jcfg, jst, jnp.asarray(iq[:2 * n]))
    st = convert.channelizer_state_tm_from_numpy(jax.device_get(jst), "cpu")
    assert st.nco_num.dtype == torch.int32
    assert st.resamp.phase.dtype == torch.int32
    st, a, _ = chan.channelize_step_tmaj(cfg, st, iq[2 * n:])
    jst, ja, _ = jchan.channelize_step_tmaj(jcfg, jst, jnp.asarray(iq[2 * n:]))
    _close(a.numpy(), ja, MIX_TOL, "continued block")
    _state_close(st, jst, MIX_TOL, "continued block")
    cst = convert.channelizer_state_from_numpy(
        jax.device_get(jchan.init_state(jcfg)), "cpu")
    assert cst.sample_index.dtype == torch.int32 and cst.sample_index.dim() == 0


def test_tmaj_matches_channel_major():
    """Inside the port: the time-major engine == the channel-major one
    (audio transposed) while streaming (tests/test_channelizer.py:79-121)."""
    cfg = chan.ChannelizerConfig(**KW)
    n = chan.block_samples(cfg, target=32768)
    iq = _fm_scene(3 * n, (192_000, -64_000, 17_000), seed=3)
    st_cm, st_tm = chan.init_state(cfg, "cpu"), chan.init_state_tmaj(cfg,
                                                                      "cpu")
    for b in range(3):
        blk = iq[b * 2 * n: (b + 1) * 2 * n]
        st_cm, a_cm, nv_cm = chan.channelize_step(cfg, st_cm, blk)
        st_tm, a_tm, nv_tm = chan.channelize_step_tmaj(cfg, st_tm, blk)
        assert int(nv_cm[0]) == int(nv_tm)
        k = int(nv_tm)
        _close(a_tm.numpy().T[:, :k], a_cm.numpy()[:, :k], MIX_TOL,
               f"block {b}")


def test_fuzz_engines_against_each_other_and_reference():
    """The differential fuzz of tests/test_channelizer.py:155-201, trimmed:
    random configs through the port's two engines and the reference's
    time-major one, rtol 2e-3 / atol 6e-3."""
    rng = np.random.default_rng(77)
    done = 0
    for trial in range(12):
        d = int(rng.choice([8, 16, 32]))
        n_ch = int(rng.integers(2, 5))
        offs = tuple(float(v) for v in rng.choice(
            np.arange(-FS // 2 + 30000, FS // 2 - 30000, 1000), n_ch,
            replace=False))
        mode = str(rng.choice(["fm", "fm", "am", "usb", "lsb"]))
        kw = dict(capture_rate=FS, offsets=offs, downsample=d, mode=mode,
                  custom_atan=int(rng.choice([0, 1, 3])) if mode == "fm"
                  else 0,
                  deemph_a=int(rng.choice([0, 7])) if mode == "fm" else 0,
                  rate_out2=int(rng.choice([-1, 32000, 24000])))
        cfg, jcfg = chan.ChannelizerConfig(**kw), jchan.ChannelizerConfig(**kw)
        n = chan.block_samples(cfg, target=16384)
        if (n // d) % 128 or not chan.tmaj_supported(cfg, n) or done >= 4:
            continue
        done += 1
        iq = _fm_scene(2 * n, offs, seed=trial, amp=35, dev=9e3, noise=0.3)
        st_cm, st_tm = chan.init_state(cfg, "cpu"), chan.init_state_tmaj(
            cfg, "cpu")
        jst = jchan.init_state_tmaj(jcfg)
        for b in range(2):
            blk = iq[b * 2 * n: (b + 1) * 2 * n]
            st_cm, a_cm, nv_cm = chan.channelize_step(cfg, st_cm, blk)
            st_tm, a_tm, nv_tm = chan.channelize_step_tmaj(cfg, st_tm, blk)
            jst, ja, jnv = jchan.channelize_step_tmaj(jcfg, jst,
                                                      jnp.asarray(blk))
            assert int(nv_cm[0]) == int(nv_tm) == int(jnv), (trial, b)
            k = int(nv_tm)
            want = a_cm.numpy()[:, :k]
            _close(a_tm.numpy().T[:, :k], want, FUZZ_TOL, f"{trial} {b}")
            _close(a_tm.numpy(), ja, FUZZ_TOL, f"{trial} {b} vs reference")
    assert done == 4


@pytest.mark.parametrize("offsets,d", [((192_000.0, -64_000.0, 17_000.0), 16),
                                       ((-1_187_500.0, 37_500.0, 600_000.0,
                                         1.0), 16)])
def test_mix_matrix_and_nco_match_reference(offsets, d):
    """The mix-decimate matrix bit for bit, and the integer NCO's phasors
    from the same exact numerators (2.4 Msps geometry included)."""
    fs = 2_400_000 if d == 16 and len(offsets) == 4 else FS
    np.testing.assert_array_equal(chan._mix_decim_matrix(offsets, d, fs),
                                  jchan._mix_decim_matrix(offsets, d, fs))
    m = 8192
    num0 = np.array([v % fs for v in (5, 123_457, fs - 1, 0)[:len(offsets)]],
                    np.int32)
    ca, sa = chan._nco_phasor_rows(offsets, fs, d, torch.as_tensor(num0), m)
    offs = np.asarray([int(o) for o in offsets], np.int64)
    jca, jsa = jchan._nco_phasor_rows(offs, fs, d, jnp.asarray(num0), m)
    np.testing.assert_allclose(ca.numpy(), np.asarray(jca), rtol=0, atol=2e-7)
    np.testing.assert_allclose(sa.numpy(), np.asarray(jsa), rtol=0, atol=2e-7)
    rows = np.arange(m, dtype=np.int64)
    want = ((offs[None, :] * d * rows[:, None]) + num0[None, :]) % fs
    th = want.astype(np.float32) * np.float32(-2.0 * np.pi / fs)
    np.testing.assert_allclose(ca.numpy(), np.cos(th), rtol=0, atol=2e-7)


def test_nco_guard_and_raw_config():
    cfg = chan.ChannelizerConfig(capture_rate=400_000_000, offsets=(1.0,),
                                 downsample=1, mode="am")
    st = chan.init_state_tmaj(cfg, "cpu")
    with pytest.raises(ValueError, match="int32 NCO"):
        chan.channelize_step_tmaj(cfg, st, np.zeros(2 * 65536, np.int16))
    raw = chan.ChannelizerConfig(capture_rate=FS, offsets=(1000.0,),
                                 downsample=16, mode="raw")
    assert not chan.tmaj_supported(raw, 4096)
    assert not chan.tmaj_supported(chan.ChannelizerConfig(
        capture_rate=FS, offsets=(0.5,), downsample=16), 4096)


@pytest.mark.parametrize("mode,atan", [("fm", 2), ("am", 0), ("usb", 0),
                                       ("lsb", 0), ("raw", 0)])
def test_channel_major_modes_match_reference(mode, atan):
    """Every mode of the channel-major engine against the reference (``-A
    lut`` at small amplitude: the reference's int32 products wrap)."""
    kw = dict(KW, mode=mode, custom_atan=atan,
              deemph_a=KW["deemph_a"] if mode == "fm" else 0,
              rate_out2=-1 if mode == "raw" else 32_000)
    cfg, jcfg = chan.ChannelizerConfig(**kw), jchan.ChannelizerConfig(**kw)
    n = chan.block_samples(cfg, target=8192)
    iq = _fm_scene(2 * n, (192_000, -64_000, 17_000), seed=6,
                   gain=2 if atan == 2 else 64)
    st, jst = chan.init_state(cfg, "cpu"), jchan.init_state(jcfg)
    for b in range(2):
        blk = iq[b * 2 * n: (b + 1) * 2 * n]
        st, a, nv = chan.channelize_step(cfg, st, blk)
        jst, ja, jnv = jchan.channelize_step(jcfg, jst, jnp.asarray(blk))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        _close(a.numpy(), ja, MIX_TOL, f"{mode} block {b}")


def test_three_stations_and_seam():
    """Three stations recovered at once (tests/test_channelizer.py:35-55),
    and two carried blocks equal one concatenated block (:58-72)."""
    stations = [(-300e3, 700.0), (0.0, 1100.0), (250e3, 1700.0)]
    cfg = chan.ChannelizerConfig(capture_rate=FS,
                                 offsets=tuple(s[0] for s in stations),
                                 downsample=32, custom_atan=1)
    n = chan.block_samples(cfg, target=FS // 4)
    t = np.arange(4 * n) / FS
    z = sum(0.4 * np.exp(1j * (2 * np.pi * off * t + np.cumsum(
        2 * np.pi * 5e3 * np.sin(2 * np.pi * tone * t) / FS)))
        for off, tone in stations)
    iq = np.empty(8 * n, np.int16)
    iq[0::2] = np.round(z.real * 16000)
    iq[1::2] = np.round(z.imag * 16000)
    st = chan.init_state(cfg, "cpu")
    parts = []
    for k in range(4):
        st, audio, _ = chan.channelize_step(cfg, st, iq[k * 2 * n:
                                                        (k + 1) * 2 * n])
        parts.append(audio.numpy())
    audio = np.concatenate(parts, axis=1)
    rate = cfg.channel_rate
    for c, (_, tone) in enumerate(stations):
        a = audio[c, rate // 100:].astype(np.float64)
        sp = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(a.size))) ** 2
        assert abs(np.fft.rfftfreq(a.size, 1 / rate)[np.argmax(sp)]
                   - tone) < 20
    fs1 = 512_000
    one = chan.ChannelizerConfig(capture_rate=fs1, offsets=(100e3,),
                                 downsample=16, custom_atan=0)
    n = chan.block_samples(one, target=8192)
    t = np.arange(2 * n) / fs1
    z = 0.5 * np.exp(1j * (2 * np.pi * 100e3 * t + np.cumsum(
        2 * np.pi * 4e3 * np.sin(2 * np.pi * 900.0 * t) / fs1)))
    blk = np.empty(4 * n, np.int16)
    blk[0::2] = np.round(z.real * 16000)
    blk[1::2] = np.round(z.imag * 16000)
    _, full, _ = chan.channelize_step(one, chan.init_state(one, "cpu"), blk)
    s2, c1, _ = chan.channelize_step(one, chan.init_state(one, "cpu"),
                                     blk[: 2 * n])
    _, c2, _ = chan.channelize_step(one, s2, blk[2 * n:])
    np.testing.assert_allclose(torch.cat([c1, c2], 1).numpy(), full.numpy(),
                               atol=2.0)
