"""The port's wire-format codecs (``rx_tools_tpu_torch.iq.formats``) bit
for bit against the reference package's and the ``c_ref`` oracle
(modelled on tests/test_formats.py), on each of the three paths a call
can take: numpy arrays through NumPy, numpy arrays through the native
C++ codecs (the port's library, built here with g++), and CPU tensors."""

import ctypes

import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu.iq import formats as ref_formats
from rx_tools_tpu_torch import native
from rx_tools_tpu_torch.iq import formats
from rx_tools_tpu_torch.native import build

PATHS = ["numpy", "native", "tensor"]


def _all16():
    # dense sweep of int16 space incl. edges (tests/test_formats.py:11-16)
    return np.concatenate([
        np.arange(-32768, -32700), np.arange(-130, 130),
        np.arange(32700, 32768), np.array([0, 1, -1, 16384, -16384])
    ]).astype(np.int16)


def _u8():
    return np.arange(256, dtype=np.uint8)


def _cs12_bytes(seed=0, triples=1000):
    return np.random.default_rng(seed).integers(0, 256, 3 * triples,
                                                dtype=np.uint8)


def _cf32(seed=3):
    """Finite float32 samples: random, half-LSB ties, clip edges."""
    rng = np.random.default_rng(seed)
    ties = ((np.arange(-50, 50) + 0.5) / np.float32(32767.0)).astype(
        np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 1.0000305,
                      -1.0000305, 1e-9, -1e-9, 10.0, -10.0], np.float32)
    return np.concatenate([(rng.standard_normal(4000) * 0.6).astype(
        np.float32), ties, edges])


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    return build.build(str(tmp_path_factory.mktemp("native")
                           / "librx_native.so"))


@pytest.fixture(params=PATHS)
def path(request, native_lib, monkeypatch):
    """Which path the port's codecs take: the library installed (native)
    or absent (numpy, tensor)."""
    lib = None
    if request.param == "native":
        lib = ctypes.CDLL(native_lib)
        native._bind(lib)
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_TRIED", True)
    return request.param


def run(fn, x, path):
    """``fn`` on ``x`` along ``path``; the result as a numpy array."""
    if path == "tensor":
        out = fn(torch.from_numpy(x.copy()))
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        return out.numpy()
    out = fn(x)
    assert isinstance(out, np.ndarray)
    return out


def _oracle_cs12(raw):
    ref = np.empty(2 * (raw.size // 3), np.int16)
    for i, (b0, b1, b2) in enumerate(raw.reshape(-1, 3).astype(int)):
        ref[2 * i] = c_ref.i16((b1 << 12) | (b0 << 4))
        ref[2 * i + 1] = c_ref.i16((b2 << 8) | (b1 & 0xF0))
    return ref


ORACLES = {
    "cs16_to_cs8": lambda x: np.array(
        [c_ref.i8(c_ref.ctrunc(int(v) / 32767.0 * 128.0 + 0.4)) for v in x],
        np.int8),
    "cs16_to_cu8": lambda x: np.array(
        [c_ref.ctrunc(int(v) / 32767.0 * 128.0 + 127.4) & 0xFF for v in x],
        np.uint8),
    "cs16_rescale8": lambda x: np.array(c_ref.rescale_cs16_to_8bit(x),
                                        np.int16),
}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_narrowing_matches_c_and_reference(name, path):
    """rtl_sdr.c:367-382 and rtl_fm.c:845-848 over the dense sweep."""
    x = _all16()
    got = run(getattr(formats, name), x, path)
    np.testing.assert_array_equal(got, ORACLES[name](x))
    np.testing.assert_array_equal(got, np.asarray(getattr(ref_formats,
                                                          name)(x)))


def test_cs16_to_cf32(path):
    x = np.arange(-32768, 32768, dtype=np.int16)
    got = run(formats.cs16_to_cf32, x, path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref_formats.cs16_to_cf32(x)))
    np.testing.assert_allclose(got, x / 32767.0, rtol=1e-6)


def test_cs12_unpack_matches_c(path):
    raw = _cs12_bytes()
    got = run(formats.cs12_to_cs16, raw, path)
    np.testing.assert_array_equal(got, _oracle_cs12(raw))
    np.testing.assert_array_equal(got, np.asarray(ref_formats.cs12_to_cs16(
        raw)))


def test_cs12_roundtrip(path):
    rng = np.random.default_rng(1)
    # true 12-bit data: low nibble zero
    x = (rng.integers(-2048, 2048, size=2000, dtype=np.int16) << 4).astype(
        np.int16)
    packed = run(formats.cs16_to_cs12, x, path)
    np.testing.assert_array_equal(packed, np.asarray(ref_formats.cs16_to_cs12(
        x)))
    np.testing.assert_array_equal(run(formats.cs12_to_cs16, packed, path), x)


def test_cs16_to_cs12_any_int16(path):
    """Packing drops the low nibble of every int16, edges included."""
    x = np.arange(-32768, 32768, dtype=np.int16)
    got = run(formats.cs16_to_cs12, x, path)
    np.testing.assert_array_equal(got, np.asarray(ref_formats.cs16_to_cs12(
        x)))
    np.testing.assert_array_equal(formats.cs12_to_cs16(got),
                                  (x & ~np.int16(0xF)).astype(np.int16))


@pytest.mark.parametrize("name,dtype", [("cu8_to_cs16", np.uint8),
                                        ("cs8_to_cs16", np.int8)])
def test_widening_all_byte_values(name, dtype, path):
    x = _u8().view(dtype)
    got = run(getattr(formats, name), x, path)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.asarray(getattr(ref_formats,
                                                          name)(x)))
    want = (x.astype(int) - (128 if dtype == np.uint8 else 0)) * 256
    np.testing.assert_array_equal(got, want)


def test_cf32_to_cs16_finite(path):
    """Round half to even, then clip (formats.py:177, iqcodec.cpp:61-68)."""
    x = _cf32()
    got = run(formats.cf32_to_cs16, x, path)
    np.testing.assert_array_equal(got, np.asarray(ref_formats.cf32_to_cs16(x)))
    want = np.clip(np.round(x.astype(np.float64) * 32767.0), -32768, 32767)
    # the float32 product rounds first; away from ties the result agrees
    # with the exact one
    exact = np.abs(x.astype(np.float64) * 32767.0 % 1.0 - 0.5) > 1e-3
    np.testing.assert_array_equal(got[exact], want[exact])


def test_float32_paths_over_all_int16():
    """The NumPy and tensor paths narrow in float32, as the reference
    package's do.  Over all of int16, CS8 and the rescale agree with the
    C's double arithmetic (the native path); CU8 leaves it at exactly two
    inputs, in both packages alike."""
    import jax.numpy as jnp
    x = np.arange(-32768, 32768, dtype=np.int16)
    t = torch.from_numpy(x)
    for name in ("cs16_to_cs8", "cs16_rescale8"):
        np.testing.assert_array_equal(getattr(formats, name)(t).numpy(),
                                      ORACLES[name](x))
    got = formats.cs16_to_cu8(t).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_formats.cs16_to_cu8(jnp.asarray(x))))
    oracle = ORACLES["cs16_to_cu8"](x)
    off = got != oracle
    np.testing.assert_array_equal(x[off], [-13158, 19609])
    np.testing.assert_array_equal(got[off], oracle[off] + 1)


PAIRS = [(i, o) for i in formats.FORMATS for o in formats.FORMATS]


@pytest.mark.parametrize("in_fmt,out_fmt", PAIRS,
                         ids=[f"{i}-{o}" for i, o in PAIRS])
def test_convert_matrix_matches_reference(in_fmt, out_fmt, path):
    """Every pair of the full conversion matrix, widened through CS16."""
    rng = np.random.default_rng(7)
    raw = formats.bytes_to_array(
        rng.integers(0, 256, 1536, dtype=np.uint8).tobytes(), in_fmt)
    if in_fmt == "CF32":
        raw = (rng.standard_normal(384) * 0.5).astype(np.float32)
    got = run(lambda v: formats.convert(v, in_fmt, out_fmt), raw, path)
    want = np.asarray(ref_formats.convert(raw, in_fmt, out_fmt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (formats.array_to_bytes(got, out_fmt)
            == ref_formats.array_to_bytes(want, out_fmt))


@pytest.mark.parametrize("fmt", formats.FORMATS)
def test_to_float_matches_reference(fmt, path):
    rng = np.random.default_rng(5)
    raw = formats.bytes_to_array(
        rng.integers(0, 256, 3072, dtype=np.uint8).tobytes(), fmt)
    if fmt == "CF32":
        raw = (rng.standard_normal(768) * 0.5).astype(np.float32)
    got = run(lambda v: formats.to_float(v, fmt), raw, path)
    want = np.asarray(ref_formats.to_float(raw, fmt))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", formats.FORMATS)
def test_bytes_roundtrip(fmt):
    blob = np.random.default_rng(9).integers(0, 256, 96, np.uint8).tobytes()
    a = formats.bytes_to_array(blob, fmt)
    np.testing.assert_array_equal(a, ref_formats.bytes_to_array(blob, fmt))
    assert a.dtype == ref_formats.bytes_to_array(blob, fmt).dtype
    assert formats.array_to_bytes(a, fmt) == blob
    assert formats.array_to_bytes(torch.from_numpy(a.copy()), fmt) == blob


def test_parse_fmt():
    assert formats.parse_fmt("cs16") == "CS16"
    assert formats.FORMATS == ref_formats.FORMATS
    assert formats.ELEM_BYTES == ref_formats.ELEM_BYTES
    with pytest.raises(ValueError):
        formats.parse_fmt("CF64")
