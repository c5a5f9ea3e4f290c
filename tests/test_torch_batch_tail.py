"""The port's batched demod-tail ops against the reference package's, on
the same seeded inputs (bounds of tests/test_batch_tail.py), and the
zero-emission block of the periodic resamplers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rx_tools_tpu import ops as jops
from rx_tools_tpu.ops import resample as jrs
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import tmaj
from rx_tools_tpu_torch.ops import filters, resample as rs

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("mode", [ops.DISC_STD, ops.DISC_FAST, ops.DISC_ALE,
                                  ops.DISC_LUT])
def test_fm_discriminate_batch_matches_reference(mode):
    rng = np.random.default_rng(0)
    c, m = 5, 257
    # small amplitude for lut: the reference's int32 products wrap above it
    amp = 20 if mode == ops.DISC_LUT else 50
    z = rng.normal(0, amp, (c, m, 2)).astype(np.float32)
    prev = rng.normal(0, amp, (c, 2)).astype(np.float32)
    pj, dj = jops.fm_discriminate_batch(jnp.asarray(prev), jnp.asarray(z),
                                        mode)
    pt, dt = ops.fm_discriminate_batch(_t(prev), _t(z), mode)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    pp, dp = ops.fm_discriminate_batch_planar(_t(prev), _t(z[..., 0]),
                                              _t(z[..., 1]), mode)
    assert torch.equal(pp, pt) and torch.equal(dp, dt)


@pytest.mark.parametrize("m", [300, 256])
def test_deemph_batch_matches_reference(m):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1000, (4, m)).astype(np.float32)
    avg = rng.normal(0, 10, (4,)).astype(np.float32)
    aj, yj = jops.deemph_filter(jnp.asarray(avg), jnp.asarray(x), 7, axis=-1)
    at, yt = ops.deemph_filter(_t(avg), _t(x), 7, axis=-1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)


def test_deemph_batch_matmul_form_matches_row_scan(monkeypatch):
    """The card's triangular-product form (forced here) against the CPU's
    row scan, and against the reference's own matmul form."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1000, (3, 512)).astype(np.float32)
    avg = rng.normal(0, 10, (3,)).astype(np.float32)
    a0, y0 = ops.deemph_filter(_t(avg), _t(x), 7, axis=-1)
    monkeypatch.setattr(filters, "_MXU_FORCE", True)
    a1, y1 = ops.deemph_filter(_t(avg), _t(x), 7, axis=-1)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), rtol=1e-5, atol=1e-3)
    from rx_tools_tpu.ops import filters as jfilters
    inv = 1.0 / 7
    aj, yj = jfilters._iir_scan_batch_mxu(
        jnp.asarray(avg), jnp.asarray(x) * jnp.float32(inv), 1.0 - inv)
    np.testing.assert_allclose(y1.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(a1.numpy(), np.asarray(aj), rtol=1e-6,
                               atol=1e-4)


def test_deemph_2d_axis0_raises():
    with pytest.raises(ValueError, match="axis"):
        ops.deemph_filter(torch.zeros(3), torch.zeros((3, 8)), 7, axis=0)


def test_resample_batch_matches_reference_over_blocks():
    """Equal-phase channels streamed over three blocks: values at rtol
    1e-5 / atol 1e-3, phase and n_valid exact."""
    rng = np.random.default_rng(2)
    c, n, fast, slow = 3, 1700, 170000, 32000
    st_j = jrs.ResampleState(jnp.zeros(c), jnp.zeros(c, jnp.int32))
    st_t = rs.ResampleState(torch.zeros(c), torch.zeros(c, dtype=torch.int32))
    for _ in range(3):
        x = rng.normal(0, 1000, (c, n)).astype(np.float32)
        st_j, yj, nvj = jrs.resample_rational_batch(st_j, jnp.asarray(x),
                                                    fast, slow)
        st_t, yt, nvt = ops.resample_rational_batch(st_t, _t(x), fast, slow)
        assert int(nvt) == int(nvj) and nvt.dtype == torch.int32
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(st_t.acc.numpy(), np.asarray(st_j.acc),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(st_t.phase.numpy(),
                                      np.asarray(st_j.phase))
        assert st_t.phase.dtype == torch.int32


@pytest.mark.parametrize("mode,atan", [("fm", ops.DISC_FAST),
                                       ("fm", ops.DISC_STD), ("am", 0),
                                       ("usb", 0), ("raw", 0)])
def test_demod_tail_batch_matches_per_channel_and_reference(mode, atan):
    """The batched demod tail == the reference's batched tail and the
    per-channel tail channel by channel (the reference's vmap premise),
    over two chained blocks: counts exact, audio at rtol 1e-5 plus 1e-5 of
    the block's full scale (the std atan2 rounds differently, so the
    absolute error follows the signal's scale, not each sample's)."""
    from rx_tools_tpu.models import channelizer as jchan
    from rx_tools_tpu_torch.models import channelizer as chan
    kw = dict(capture_rate=1_024_000, offsets=(1000.0, 2000.0, 3000.0),
              downsample=16, mode=mode, custom_atan=atan,
              deemph_a=7 if mode == "fm" else 0,
              rate_out2=-1 if mode == "raw" else 32_000)
    cfg, jcfg = chan.ChannelizerConfig(**kw), jchan.ChannelizerConfig(**kw)
    rng = np.random.default_rng(8)
    c = 3
    st = [np.zeros((c, 2), np.float32), np.zeros(c, np.float32),
          np.zeros(c, np.float32), np.zeros(c, np.int32)]
    bt, jt = [_t(v) for v in st], [jnp.asarray(v) for v in st]
    per = [[_t(v[i]) for v in st] for i in range(c)]
    for _ in range(2):
        t = np.arange(1024) + 1024 * _
        # zero-mean audio, as the reference's random input is: the window
        # sums are differences of prefix sums, whose rounding scales with
        # the running total
        z = np.stack([40 * np.exp(1j * 20 * np.sin((0.01 + 0.002 * i) * t))
                      for i in range(c)])
        z = z + rng.normal(0, 0.5, z.shape) + 1j * rng.normal(0, 0.5, z.shape)
        x = np.stack([z.real, z.imag], -1).astype(np.float32)
        *bt, a, nv = chan.demod_tail_batch(cfg, *bt, _t(x))
        *jt, ja, jnv = jchan.demod_tail_batch(jcfg, *jt, jnp.asarray(x))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
        scale = float(np.abs(a.numpy()).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-5 * scale)
        # the flat resampler's prefix sums round per running total: the
        # bound of tests/test_torch_ops.py:194 for differently associated
        # prefix sums
        for i in range(c):
            *per[i], ai, nvi = chan.demod_tail(cfg, *per[i], _t(x[i]))
            assert int(nvi) == int(nv[i])
            np.testing.assert_allclose(ai.numpy()[: int(nvi)],
                                       a.numpy()[i, : int(nvi)], rtol=1e-5,
                                       atol=2e-2 + 1e-5 * scale)


def test_resample_batch_guards():
    st = rs.ResampleState(torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds input rate"):
        ops.resample_rational_batch(st, torch.zeros((2, 64)), 32000, 48000)
    with pytest.raises(ValueError, match="int32 resampler phase"):
        ops.resample_rational_batch(st, torch.zeros((2, 1 << 16)), 40001,
                                    40000)


@pytest.mark.parametrize("fast,slow", [(37500, 32000), (150000, 32000),
                                       (48000, 32000)])
def test_cm_periodic_matches_general_batch(fast, slow):
    """The periodic-mask form against the cumsum form while streaming, and
    against the reference's periodic form (rtol 1e-4 / atol 0.5; grid,
    counts and phase exact)."""
    rng = np.random.default_rng(51)
    c = 8
    z = (np.zeros(c, np.float32), np.zeros(c, np.int32))
    st_a = rs.ResampleState(_t(z[0]), _t(z[1]))
    st_b = st_a
    st_j = jrs.ResampleState(jnp.asarray(z[0]), jnp.asarray(z[1]))
    for blk in range(3):
        x = rng.normal(0, 5000, (c, 1024)).astype(np.float32)
        st_a, ya, nva = rs._resample_cm_periodic(st_a, _t(x), fast, slow)
        st_b, yb, nvb = ops.resample_rational_batch(st_b, _t(x), fast, slow)
        st_j, yj, nvj = jrs._resample_cm_periodic(st_j, jnp.asarray(x), fast,
                                                  slow)
        assert int(nva) == int(nvb) == int(nvj), (fast, slow, blk)
        for y, acc in ((yb, st_b.acc), (np.asarray(yj), np.asarray(st_j.acc))):
            np.testing.assert_allclose(ya.numpy(), np.asarray(y), rtol=1e-4,
                                       atol=0.5, err_msg=f"blk {blk}")
            np.testing.assert_allclose(st_a.acc.numpy(), np.asarray(acc),
                                       rtol=1e-4, atol=0.5)
        assert int(st_a.phase[0]) == int(st_b.phase[0]) == int(st_j.phase[0])


ACC0 = np.array([7.5, -3.0, 12.0, 1.5], np.float32)


def _zero_emission_blocks():
    """Ratio 301/2, 128-sample blocks from phase 0: the first block emits
    nothing, the next ones one output each (ADVICE.md:3's reproduction);
    the states start from a non-zero ``acc`` (:data:`ACC0`)."""
    rng = np.random.default_rng(5)
    return [rng.normal(0, 100, (4, 128)).astype(np.float32) for _ in range(4)]


def test_periodic_resamplers_carry_acc_over_zero_emission_block():
    """Both periodic forms (channel-major and time-major) carry ``acc``
    across a block that emits nothing, as the cumsum form does."""
    fast, slow = 301, 2
    z = rs.ResampleState(_t(ACC0), torch.zeros(4, dtype=torch.int32))
    st_p = st_c = st_t = st_r = z
    counts = []
    for x in _zero_emission_blocks():
        st_p, yp, nvp = rs._resample_cm_periodic(st_p, _t(x), fast, slow)
        st_c, yc, nvc = ops.resample_rational_batch(st_c, _t(x), fast, slow)
        st_t, yt, nvt = tmaj._resample_tmaj_periodic(st_t, _t(x.T.copy()),
                                                     fast, slow)
        st_r, yr, nvr = tmaj._resample_tmaj(st_r, _t(x.T.copy()), fast, slow)
        assert int(nvp) == int(nvc) == int(nvt) == int(nvr)
        counts.append(int(nvp))
        np.testing.assert_allclose(yp.numpy(), yc.numpy(), rtol=1e-4,
                                   atol=0.5)
        np.testing.assert_allclose(yt.numpy(), yr.numpy(), rtol=1e-4,
                                   atol=0.5)
        np.testing.assert_allclose(yt.numpy().T, yc.numpy(), rtol=1e-4,
                                   atol=0.5)
        for st in (st_p, st_t, st_r):
            np.testing.assert_allclose(st.acc.numpy(), st_c.acc.numpy(),
                                       rtol=1e-4, atol=0.5)
    assert 0 in counts and max(counts) > 0, counts


def test_reference_periodic_resampler_drops_acc_on_zero_emission_block():
    """Pins the reference package's fault that the port does not share
    (ADVICE.md:3): on the block that emits nothing, its periodic form
    returns the block's sum without the incoming ``acc``."""
    fast, slow = 301, 2
    st_j = jrs.ResampleState(jnp.asarray(ACC0), jnp.zeros(4, jnp.int32))
    st_c = rs.ResampleState(_t(ACC0), torch.zeros(4, dtype=torch.int32))
    for x in _zero_emission_blocks():
        acc_in = st_c.acc.numpy().copy()
        st_j, _, nvj = jrs._resample_cm_periodic(st_j, jnp.asarray(x), fast,
                                                 slow)
        st_c, _, nvc = ops.resample_rational_batch(st_c, _t(x), fast, slow)
        assert int(nvj) == int(nvc)
        if int(nvj) == 0:
            assert np.abs(acc_in).min() > 1.0
            np.testing.assert_allclose(np.asarray(st_j.acc) + acc_in,
                                       st_c.acc.numpy(), rtol=1e-4, atol=0.5)
            return
        np.testing.assert_allclose(np.asarray(st_j.acc), st_c.acc.numpy(),
                                   rtol=1e-4, atol=0.5)
    raise AssertionError("no block emitted nothing")
