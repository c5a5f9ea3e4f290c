"""The port's native library (``rx_tools_tpu_torch.native``), built here
with g++, against the ``c_ref`` oracle, the reference package's NumPy
codecs and the port's tensor codecs; its readahead ``Feeder`` and the file
source that reads through it (modelled on tests/test_native.py)."""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu.iq import formats as ref_formats
from rx_tools_tpu.iq import sources as ref_sources
from rx_tools_tpu_torch import native
from rx_tools_tpu_torch.iq import formats, sources
from rx_tools_tpu_torch.native import build
from rx_tools_tpu_torch.utils.wav import write_wav_header


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    return build.build(str(tmp_path_factory.mktemp("native")
                           / "librx_native.so"))


@pytest.fixture
def lib(native_lib, monkeypatch):
    """The library installed as the port's loaded one."""
    handle = ctypes.CDLL(native_lib)
    native._bind(handle)
    monkeypatch.setattr(native, "_LIB", handle)
    monkeypatch.setattr(native, "_TRIED", True)
    return handle


def _all16():
    return np.arange(-32768, 32768, dtype=np.int16)


def test_build_writes_where_the_loader_looks(tmp_path):
    """The default build goes to build/native/ at the root of the
    checkout, never into a package directory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert native.LIB_PATH == os.path.join(os.path.dirname(root), "build",
                                           "native", "librx_native.so")
    out = build.build(str(tmp_path / "sub" / "librx_native.so"))
    assert os.path.exists(out) and not os.path.exists(out + f".{os.getpid()}.tmp")


def test_unbuilt_library_is_unavailable(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    with pytest.raises(RuntimeError, match="not built"):
        native.Feeder(0, 4096)


def test_cs8_cu8_rescale_match_oracle_dense(lib):
    """Full int16 sweep vs the C oracle (double math, trunc-to-zero)."""
    x = _all16()
    ref8 = np.array([c_ref.i8(c_ref.ctrunc(int(v) / 32767.0 * 128.0 + 0.4))
                     for v in x], np.int8)
    np.testing.assert_array_equal(native.cs16_to_cs8(x), ref8)
    refu = np.array([c_ref.ctrunc(int(v) / 32767.0 * 128.0 + 127.4) & 0xFF
                     for v in x], np.uint8)
    np.testing.assert_array_equal(native.cs16_to_cu8(x), refu)
    refr = np.array([c_ref.i16(c_ref.ctrunc(int(v) / 32767.0 * 128.0 + 0.4))
                     for v in x], np.int16)
    np.testing.assert_array_equal(native.cs16_rescale8(x), refr)


def test_cs12_roundtrip_and_oracle(lib):
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 3 * 1000, dtype=np.uint8)
    got = native.cs12_to_cs16(raw)
    ref = np.empty(2000, np.int16)
    b = raw.reshape(-1, 3).astype(int)
    for i, (b0, b1, b2) in enumerate(b):
        ref[2 * i] = c_ref.i16((b1 << 12) | (b0 << 4))
        ref[2 * i + 1] = c_ref.i16((b2 << 8) | (b1 & 0xF0))
    np.testing.assert_array_equal(got, ref)
    x12 = (rng.integers(-2048, 2048, 2000, dtype=np.int16) << 4).astype(
        np.int16)
    np.testing.assert_array_equal(native.cs12_to_cs16(native.cs16_to_cs12(x12)),
                                  x12)


def test_widening_and_cf32_match_reference_numpy(lib):
    u = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(native.cu8_to_cs16(u),
                                  ref_formats.cu8_to_cs16(u))
    np.testing.assert_array_equal(native.cs8_to_cs16(u.view(np.int8)),
                                  ref_formats.cs8_to_cs16(u.view(np.int8)))
    x = _all16()
    np.testing.assert_array_equal(native.cs16_to_cf32(x),
                                  ref_formats.cs16_to_cf32(x))
    f = np.concatenate([native.cs16_to_cf32(x),
                        (np.random.default_rng(4).standard_normal(5000)
                         * 0.7).astype(np.float32),
                        np.array([1.5, -1.5, 7.0, -7.0], np.float32)])
    np.testing.assert_array_equal(native.cf32_to_cs16(f),
                                  ref_formats.cf32_to_cs16(f))
    # CF32 round-trips every int16 exactly
    np.testing.assert_array_equal(native.cf32_to_cs16(native.cs16_to_cf32(x)),
                                  x)


@pytest.mark.parametrize("block,depth", [(4096, 3), (65536, 8), (1, 2),
                                         (123457, 1)])
def test_feeder_lossless_file(tmp_path, lib, block, depth):
    data = np.random.default_rng(1).integers(0, 256, 123457, dtype=np.uint8)
    path = tmp_path / "blob"
    path.write_bytes(data.tobytes())
    fd = os.open(str(path), os.O_RDONLY)
    try:
        f = native.Feeder(fd, block, depth=depth, drop_on_full=False)
        chunks = []
        while True:
            b = f.read_block(timeout_ms=5000)
            if b is None:
                break
            chunks.append(b)
        got = np.concatenate(chunks)
        np.testing.assert_array_equal(got, data)
        assert f.overflows == 0 and f.queued == 0
        f.close()
    finally:
        os.close(fd)


def test_feeder_timeout_then_eof(lib):
    """A pipe with nothing in it times out; closing its writer ends it."""
    r, w = os.pipe()
    try:
        f = native.Feeder(r, 64, depth=2)
        with pytest.raises(TimeoutError):
            f.read_block(timeout_ms=50)
        os.write(w, b"\x01" * 64)
        assert f.read_block(timeout_ms=5000).tolist() == [1] * 64
        os.close(w)
        w = None
        assert f.read_block(timeout_ms=5000) is None
        f.close()
    finally:
        if w is not None:
            os.close(w)
        os.close(r)


@pytest.mark.parametrize("name,make", [
    ("cs16_to_cs8", lambda r: r.integers(-32768, 32767, 4096).astype(np.int16)),
    ("cs16_to_cu8", lambda r: r.integers(-32768, 32767, 4096).astype(np.int16)),
    ("cs16_to_cf32", lambda r: r.integers(-32768, 32767, 4096).astype(
        np.int16)),
    ("cs16_rescale8", lambda r: r.integers(-32768, 32767, 4096).astype(
        np.int16)),
    ("cs16_to_cs12", lambda r: r.integers(-32768, 32767, 4096).astype(
        np.int16)),
    ("cu8_to_cs16", lambda r: r.integers(0, 256, 4096, dtype=np.uint8)),
    ("cs8_to_cs16", lambda r: r.integers(-128, 128, 4096).astype(np.int8)),
    ("cs12_to_cs16", lambda r: r.integers(0, 256, 3 * 1365, dtype=np.uint8)),
    ("cf32_to_cs16", lambda r: (r.standard_normal(4096) * 0.6).astype(
        np.float32)),
])
def test_formats_dispatch_native_and_tensor_alike(lib, name, make):
    """The formats layer gives the same bits through the library (numpy
    input) and through torch (tensor input)."""
    x = make(np.random.default_rng(2))
    fn = getattr(formats, name)
    assert formats._use_native(x)
    via_native = fn(x)
    via_tensor = fn(torch.from_numpy(x.copy())).numpy()
    assert via_native.dtype == via_tensor.dtype
    np.testing.assert_array_equal(via_native, via_tensor)


def _cs16_capture(n=50000, seed=6):
    return np.random.default_rng(seed).integers(-20000, 20000, 2 * n).astype(
        np.int16)


@pytest.mark.parametrize("fmt", formats.FORMATS)
def test_file_source_reads_ahead_losslessly(tmp_path, lib, fmt):
    """A file of every wire format through the Feeder: the same CS16
    stream as the reference package's FileSource, in odd read sizes."""
    raw = formats.convert(_cs16_capture(), "CS16", fmt)
    path = tmp_path / f"cap.{fmt}"
    path.write_bytes(formats.array_to_bytes(raw, fmt))
    q = f"file={path},format={fmt}"
    src, ref = sources.make_source(q), ref_sources.make_source(q)
    assert src._feeder is not None
    got, want = [], []
    for n in (1000, 33333, 7, 65536, 65536):
        a, b = src.read_stream(n), ref.read_stream(n)
        assert a[0] == b[0]
        got.append(a[1])
        want.append(b[1])
    assert src.read_stream(10)[0] == 0
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert sum(g.size for g in got) == 2 * 50000
    src.close()
    ref.close()


def test_wav_capture_through_feeder(tmp_path, lib):
    """A WAV capture: the source re-opens at the data chunk so the
    Feeder's raw fd starts there (sources.py's re-open comment)."""
    iq = _cs16_capture(20000)
    path = tmp_path / "cap.wav"
    with open(path, "wb") as f:
        write_wav_header(f, 240000, stereo=True)
        f.write(iq.tobytes())
    src = sources.make_source(f"file={path}")
    assert src._feeder is not None and src.sample_rate == 240000
    n, buf = src.read_stream(20000)
    assert n == 20000
    np.testing.assert_array_equal(buf, iq)
    src.close()


def test_feeder_skipped_for_loop_and_stdin(tmp_path, lib, monkeypatch):
    path = tmp_path / "cap.cs16"
    _cs16_capture(100).tofile(path)
    src = sources.make_source(f"file={path},format=CS16,loop=1")
    assert src._feeder is None
    n, buf = src.read_stream(250)        # wraps around the 100-sample file
    assert n == 250
    np.testing.assert_array_equal(buf[:200], buf[200:400])
    src.close()

    class _Stdin:
        buffer = open(path, "rb")
    monkeypatch.setattr(sys, "stdin", _Stdin)
    try:
        src = sources.make_source("stdin,format=CS16")
        assert src._feeder is None
        assert src.read_stream(100)[0] == 100
    finally:
        _Stdin.buffer.close()
