"""The port's capture-side ops against the reference package's on the same
numpy inputs: fs/4 rotate, raw DC block, the CIC droop table, the carried
boxcar, the fifth-order cascade and droop FIR (carry across split blocks),
the polyphase FIR decimator and the sinc resampler (tests/test_ops_fir.py,
tests/test_polyfir.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu import ops as ref_ops
from rx_tools_tpu.ops import cic as ref_cic
from rx_tools_tpu.ops import polyfir as ref_polyfir
from rx_tools_tpu.ops import resample as ref_resample
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.ops import cic, demods, polyfir, resample

torch.set_num_threads(2)

# float stage tolerance (the reference's own split-vs-whole bounds)
STAGE = dict(rtol=1e-5, atol=1e-5)


def _iq(n, seed=0, lo=-120, hi=120):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, 2)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rotate_int_exact_and_float():
    rng = np.random.default_rng(3)
    blk = rng.integers(-32768, 32767, 2 * 64).astype(np.int16)
    blk[:4] = (-32768, 5, -32768, -32768)          # the int16 wrap
    want = np.array(c_ref.rotate16_90(blk), np.int16)
    got = ops.rotate_fs4_int16(_t(blk).reshape(-1, 2)).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    x = _iq(64)
    np.testing.assert_array_equal(
        ops.rotate_fs4(_t(x)).numpy(),
        np.asarray(ref_ops.rotate_fs4(jnp.asarray(x))))
    with pytest.raises(ValueError):
        ops.rotate_fs4(_t(x[:6]))


def test_dc_block_raw_matches_reference():
    x = _iq(480, seed=1) + np.float32(7.5)
    st, rst = torch.tensor([1.0, -2.0]), jnp.asarray([1.0, -2.0], jnp.float32)
    for blk in np.split(x, 3):
        st, y = ops.dc_block_raw(st, _t(blk))
        rst, ry = ref_ops.dc_block_raw(rst, jnp.asarray(blk))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **STAGE)
        np.testing.assert_allclose(st.numpy(), np.asarray(rst), rtol=1e-5)


def test_cic_table_equal():
    np.testing.assert_array_equal(cic.CIC_9_TABLES, ref_cic.CIC_9_TABLES)
    for p in range(1, cic.CIC_TABLE_MAX + 1):
        got = cic.cic_9_taps(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref_cic.cic_9_taps(p))
    for bad in (0, cic.CIC_TABLE_MAX + 1):
        with pytest.raises(ValueError):
            cic.cic_9_taps(bad)


@pytest.mark.parametrize("d,cuts", [(7, (0, 13, 50, 56, 112)),
                                    (6, (0, 96, 192)), (5, (0, 3, 4, 60))])
def test_boxcar_carry_matches_reference_and_oracle(d, cuts):
    """Carried boxcar over unaligned split points == the reference op and
    the one-shot C low_pass."""
    x = _iq(cuts[-1], seed=d)
    want, _ = c_ref.low_pass(x.reshape(-1).astype(np.int16), d)
    st, rst = ops.BoxcarState.init(), ref_ops.BoxcarState.init()
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y, nv = ops.boxcar_decimate(st, _t(x[a:b]), d)
        rst, ry, rnv = ref_ops.boxcar_decimate(rst, jnp.asarray(x[a:b]), d)
        assert int(nv) == int(rnv)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **STAGE)
        assert int(st.phase) == int(rst.phase)
        assert st.phase.dtype == torch.int32
        outs.append(y.numpy()[: int(nv)])
    np.testing.assert_allclose(np.concatenate(outs).reshape(-1),
                               np.array(want, np.float32))


@pytest.mark.parametrize("passes", [1, 2, 4])
def test_fifth_order_cascade_carry(passes):
    """Split blocks with carry == the reference op block for block, and
    == one whole block (tests/test_ops_fir.py:88-101, atol 1e-3)."""
    x = _iq(64 << passes, seed=passes)
    half = x.shape[0] // 2
    st = ops.FifthOrderState.init(passes)
    rst = ref_ops.FifthOrderState.init(passes)
    ys = []
    for blk in (x[:half], x[half:]):
        st, y = ops.fifth_order_cascade(st, _t(blk), passes)
        rst, ry = ref_ops.fifth_order_cascade(rst, jnp.asarray(blk), passes)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **STAGE)
        np.testing.assert_allclose(st.hist.numpy(), np.asarray(rst.hist),
                                   **STAGE)
        ys.append(y.numpy())
    _, whole = ops.fifth_order_cascade(ops.FifthOrderState.init(passes),
                                       _t(x), passes)
    np.testing.assert_allclose(whole.numpy(), np.concatenate(ys), atol=1e-3)


@pytest.mark.parametrize("passes", [1, 4])
def test_droop_fir_carry(passes):
    x = _iq(128, seed=6)
    st, rst = ops.DroopState.init(), ref_ops.DroopState.init()
    ys = []
    for blk in (x[:50], x[50:]):
        st, y = ops.droop_fir(st, _t(blk), passes)
        rst, ry = ref_ops.droop_fir(rst, jnp.asarray(blk), passes)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **STAGE)
        ys.append(y.numpy())
    np.testing.assert_array_equal(st.hist.numpy(), np.asarray(rst.hist))
    _, whole = ops.droop_fir(ops.DroopState.init(), _t(x), passes)
    np.testing.assert_allclose(whole.numpy(), np.concatenate(ys), atol=1e-3)


@pytest.mark.parametrize("n_taps,cutoff", [(49, 1 / 8), (64, 1 / 6),
                                           (65, 1 / 14)])
def test_design_lowpass_equal(n_taps, cutoff):
    got = polyfir.design_lowpass(n_taps, cutoff)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  ref_polyfir.design_lowpass(n_taps, cutoff))


@pytest.mark.parametrize("n_taps,d", [(49, 8), (64, 6)])
def test_fir_decimate_matches_reference(n_taps, d):
    """Block for block against the reference's strided convolution, and
    split == whole (tests/test_polyfir.py:12-24)."""
    rng = np.random.default_rng(n_taps)
    x = rng.standard_normal((32 * d, 2)).astype(np.float32)
    taps = polyfir.design_lowpass(n_taps, 1.0 / d)
    st = polyfir.PolyFirState.init(n_taps)
    rst = ref_polyfir.PolyFirState.init(n_taps)
    ys = []
    for blk in (x[:16 * d], x[16 * d:]):
        st, y = polyfir.fir_decimate(st, _t(blk), _t(taps), d)
        rst, ry = ref_polyfir.fir_decimate(rst, jnp.asarray(blk),
                                           jnp.asarray(taps), d)
        assert y.shape == (16, 2)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **STAGE)
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(rst.tail))
        ys.append(y.numpy())
    _, whole = polyfir.fir_decimate(polyfir.PolyFirState.init(n_taps), _t(x),
                                    _t(taps), d)
    np.testing.assert_allclose(whole.numpy(), np.concatenate(ys), **STAGE)
    # DC gain == D once the tail fills (tests/test_polyfir.py:27-33)
    _, dc = polyfir.fir_decimate(polyfir.PolyFirState.init(65),
                                 torch.full((160, 2), 3.0),
                                 _t(polyfir.design_lowpass(65, 1 / 8)), 8)
    np.testing.assert_allclose(dc.numpy()[-4:], 24.0, rtol=1e-4)


@pytest.mark.parametrize("fast,slow,taps,cuts", [
    (171428, 32000, 16, (0, 1500, 4096)),
    (170000, 32000, 32, (0, 1368, 2736, 4104)),
    (96000, 48000, 32, (0, 700, 701, 2000)),
])
def test_resample_sinc_matches_reference(fast, slow, taps, cuts):
    """Per block: same n_valid and phase carry (exact), values at the
    reference test's bound; split == whole (tests/test_polyfir.py:79-93)."""
    rng = np.random.default_rng(taps)
    x = rng.standard_normal(cuts[-1]).astype(np.float32)
    st = resample.SincResampleState.init(taps)
    rst = ref_resample.SincResampleState.init(taps)
    got = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y, nv = ops.resample_sinc(st, _t(x[a:b]), fast, slow, taps=taps)
        rst, ry, rnv = ref_resample.resample_sinc(rst, jnp.asarray(x[a:b]),
                                                  fast, slow, taps=taps)
        assert int(nv) == int(rnv)
        assert st.num.dtype == torch.int32 and int(st.num) == int(rst.num)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-4,
                                   atol=1e-4)
        got.append(y.numpy()[: int(nv)])
    _, yw, nw = ops.resample_sinc(resample.SincResampleState.init(taps),
                                  _t(x), fast, slow, taps=taps)
    got = np.concatenate(got)
    assert abs(got.size - int(nw)) <= 1
    m = min(got.size, int(nw))
    np.testing.assert_allclose(got[:m], yw.numpy()[:m], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        resample._sinc_phase_lut(taps, 128, min(1.0, slow / fast)),
        ref_resample._sinc_phase_lut(taps, 128, min(1.0, slow / fast)))


def test_resample_sinc_refuses_int32_overflow():
    with pytest.raises(ValueError):
        ops.resample_sinc(resample.SincResampleState.init(16),
                          torch.zeros(1 << 20), 170001, 32000)


@pytest.mark.parametrize("name", ["am_demod", "usb_demod", "lsb_demod"])
def test_demods_match_reference(name):
    x = _iq(300, seed=2)
    # float stage: XLA may contract am's I*I + Q*Q into one multiply-add
    np.testing.assert_allclose(
        getattr(demods, name)(_t(x), 3).numpy(),
        np.asarray(getattr(ref_ops, name)(jnp.asarray(x), 3)), **STAGE)
