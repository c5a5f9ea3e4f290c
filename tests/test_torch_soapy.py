"""The port's SoapySource against a fake libSoapySDR (tests/fake_soapy.cpp,
built here in both setupStream ABIs), case for case as tests/test_soapy.py
holds the reference package's: struct layouts, string ownership, both
ABIs, enumeration, readSetting verification, the per-driver auto-gain
quirks, stream error mapping, the -I wire formats; then rx_sdr and rx_fm
from the fake device against the reference CLIs."""

import ctypes
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.apps import rx_sdr as ref_rx_sdr
from rx_tools_tpu.iq import soapy as ref_soapy
from rx_tools_tpu_torch.apps import common, rx_fm, rx_sdr
from rx_tools_tpu_torch.iq import formats, soapy, sources

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).parent


def _compile(tmpdir: pathlib.Path, old_abi: bool) -> pathlib.Path:
    out = tmpdir / ("libfakesoapy_old.so" if old_abi else "libfakesoapy.so")
    cmd = ["g++", "-shared", "-fPIC", "-O1", "-o", str(out),
           str(HERE / "fake_soapy.cpp")]
    if old_abi:
        cmd.insert(1, "-DOLD_ABI")
    subprocess.run(cmd, check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def fake_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fakesoapy")
    return {False: _compile(d, old_abi=False), True: _compile(d, old_abi=True)}


def _install(module, path, monkeypatch):
    lib = ctypes.CDLL(str(path))
    module._bind(lib)
    monkeypatch.setattr(module, "_LIB", lib)
    monkeypatch.setattr(module, "_TRIED", True)
    return lib


@pytest.fixture
def use_fake(fake_libs, monkeypatch):
    return _install(soapy, fake_libs[False], monkeypatch)


@pytest.fixture
def use_fake_old(fake_libs, monkeypatch):
    return _install(soapy, fake_libs[True], monkeypatch)


@pytest.fixture(params=[False, True], ids=["abi08", "abi07"])
def both_packages(request, fake_libs, monkeypatch):
    """The fake installed in the port and in the reference package, in
    one ABI; RX_PLATFORM=cpu for the CLIs."""
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    _install(ref_soapy, fake_libs[request.param], monkeypatch)
    return _install(soapy, fake_libs[request.param], monkeypatch)


def test_abi_detection(fake_libs, monkeypatch):
    assert _install(soapy, fake_libs[False], monkeypatch)._modern_abi is True
    assert _install(soapy, fake_libs[True], monkeypatch)._modern_abi is False


def test_missing_library_raises_like_reference(monkeypatch, capsys):
    monkeypatch.setattr(soapy, "_LIB", None)
    monkeypatch.setattr(soapy, "_TRIED", True)
    assert not soapy.available()
    with pytest.raises(RuntimeError, match="SoapySDR library not found"):
        sources.make_source("driver=rtlsdr")
    with pytest.raises(SystemExit) as e:
        common.verbose_device_search("driver=rtlsdr")
    assert e.value.code == 1
    assert "Failed to open source" in capsys.readouterr().err


def test_make_and_enumerate(use_fake):
    src = sources.make_source("driver=rtlsdr")
    try:
        assert isinstance(src, soapy.SoapySource)
        assert src.driver == "RTLSDR"
        assert src.hardware == "FAKE0001"
        info = src.info()
        assert info["num_channels"] == 2
        assert info["antennas"] == ["RX", "TX"]
        assert info["gains"] == ["TUNER"]
        assert info["frequencies"] == ["RF", "CORR"]
        assert 2400000.0 in info["sample_rates"]
        assert 8000000.0 in info["bandwidths"]
        assert info["hardware_info"] == {"origin": "fake_soapy.cpp",
                                         "serial": "00000001"}
    finally:
        src.close()


def test_show_device_info_real_hardware_layout(use_fake, capsys):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        sources.show_device_info(src)
    finally:
        src.close()
    err = capsys.readouterr().err
    assert "Using device FAKE0001" in err
    assert "Found 2 channel(s) :" in err
    assert "Found 2 antenna(s): RX TX" in err
    assert "Found 1 gain(s): TUNER" in err
    assert "Found 2 frequencies: RF CORR" in err
    assert "sample rates" in err and "2400000" in err
    assert "bandwidths" in err and "8000000" in err


def test_make_failure_raises(use_fake):
    with pytest.raises(RuntimeError, match="makeStrArgs failed"):
        soapy.SoapySource("driver=rtlsdr,fail=make")


def test_channel_validation(use_fake):
    with pytest.raises(RuntimeError, match="Invalid channel 5"):
        soapy.SoapySource("driver=rtlsdr", channel=5)


def test_setters_and_readback(use_fake):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        assert src.set_sample_rate(2_400_000) == 0
        assert src.set_frequency(101.1e6) == 0
        assert src.get_frequency() == 101.1e6
        assert src.set_bandwidth(300e3) == 0
        assert src.set_antenna("RX") == 0
        assert src.set_frequency_correction(12) == 0
        assert src.write_setting("direct_samp", "2") == 0
        assert src.read_setting("direct_samp") == "2"  # true HW readback
        assert src.read_setting("never_written") is None
    finally:
        src.close()


def test_direct_sampling_readback_messages(use_fake, capsys):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        common.verbose_direct_sampling(src, 2)
        assert ("Enabled direct sampling mode, input 2/Q."
                in capsys.readouterr().err)
        common.verbose_offset_tuning(src)
        assert "Offset tuning mode enabled." in capsys.readouterr().err
    finally:
        src.close()


@pytest.mark.parametrize("key,fn,msg", [
    ("direct_samp", lambda s: common.verbose_direct_sampling(s, 1),
     "WARNING: Failed to set direct sampling mode."),
    ("offset_tune", common.verbose_offset_tuning,
     "WARNING: Failed to set offset tuning."),
])
def test_rejected_setting_surfaces_warning(use_fake, capsys, key, fn, msg):
    """A driver that rejects direct_samp / offset_tune must WARN, not
    silently claim success (convenience.c:198-201,221-223)."""
    src = soapy.SoapySource(f"driver=rtlsdr,reject={key}")
    try:
        fn(src)
        assert msg in capsys.readouterr().err
    finally:
        src.close()


def test_auto_gain_rtlsdr_quirk(use_fake, capsys):
    """RTLSDR auto gain = 40 dB 'semi-automatic' (convenience.c:255-262)."""
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        common.verbose_gain_str_set(src, None)
        assert ("Tuner gain semi-automatically set to 40 dB"
                in capsys.readouterr().err)
    finally:
        src.close()


def test_auto_gain_hackrf_quirk(use_fake, capsys):
    """HackRF auto gain = LNA 40 / VGA 20 / AMP 0 (convenience.c:265-280)."""
    src = soapy.SoapySource("driver=hackrf")
    try:
        common.verbose_gain_str_set(src, None)
        err = capsys.readouterr().err
        assert "WARNING" not in err
        # element values land on the fake device
        assert src.gains == {"LNA": 40.0, "VGA": 20.0, "AMP": 0.0}
    finally:
        src.close()


def test_auto_gain_other_driver_leaves_defaults(use_fake, capsys):
    src = soapy.SoapySource("")
    try:
        assert src.driver == "FakeSDR"
        common.verbose_gain_str_set(src, None)
        assert "Using automatic gain control." in capsys.readouterr().err
    finally:
        src.close()


def test_gain_element_unknown_name_fails(use_fake):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        assert src.set_gain_element("TUNER", 20.0) == 0
        assert src.set_gain_element("BOGUS", 1.0) != 0
    finally:
        src.close()


def test_stream_reads_are_continuous(use_fake):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        src.activate()
        n1, b1 = src.read_stream(1000)
        n2, b2 = src.read_stream(1000)
        assert n1 == n2 == 1000
        # fake generates a ramp on the absolute counter: continuity check
        assert b1[0::2][0] == 0 and b2[0::2][0] == 1000
        assert np.array_equal(b2[1::2], -b2[0::2])
    finally:
        src.deactivate()
        src.close()


def test_overflow_maps_to_soft_code(use_fake):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        src.activate()
        src.write_setting("fake_overflow", "2")
        assert src.read_stream(100)[0] == sources.ERR_OVERFLOW
        assert src.read_stream(100)[0] == sources.ERR_OVERFLOW
        n, _ = src.read_stream(100)
        assert n == 100
    finally:
        src.close()


def test_inactive_stream_times_out(use_fake):
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        n, buf = src.read_stream(64)
        assert n == sources.ERR_TIMEOUT and buf.size == 0
        assert soapy.last_error() == "fake: stream not active"
    finally:
        src.close()


def test_err_to_str(use_fake):
    assert soapy.err_to_str(-4, use_fake) == "OVERFLOW"
    assert soapy.err_to_str(-1, use_fake) == "TIMEOUT"


def test_old_abi_setup_and_read(use_fake_old):
    """The pre-0.8 setupStream signature (convenience.c:500-504)."""
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        assert src._stream
        src.activate()
        n, b = src.read_stream(256)
        assert n == 256 and b.size == 512
    finally:
        src.close()


def test_activation_chatter_suppressed_e2e(both_packages, capfdbinary):
    """rx_sdr -d driver=... records from the fake device; activation printf
    lands on stderr; the bytes are the reference CLI's."""
    outs = []
    for main in (ref_rx_sdr.main, rx_sdr.main):
        rc = main(["-d", "driver=rtlsdr", "-f", "100M", "-s", "2400k",
                   "-n", "4096", "-F", "CS16", "-"])
        assert rc == 0
        cap = capfdbinary.readouterr()
        assert b"fake driver: stream activated" not in cap.out
        assert b"fake driver: stream activated" in cap.err
        outs.append(cap.out)
    assert outs[1] == outs[0]
    assert len(outs[1]) == 4 * 4096
    # the recorded bytes are the fake's deterministic ramp
    arr = np.frombuffer(outs[1], np.int16)
    assert arr[0] == 0 and arr[2] == 1


# --- -I wire formats reach the hardware (rtl_sdr.c:138,176,301) -----------

def _cs12_ramp_bytes(start: int, n: int) -> np.ndarray:
    """The fake device's CS12 wire bytes for samples [start, start+n)."""
    k = np.arange(start, start + n, dtype=np.int64)
    i12 = (k & 0xFFF).astype(np.uint32)
    q12 = (~k & 0xFFF).astype(np.uint32)
    out = np.empty(3 * n, np.uint8)
    out[0::3] = i12 & 0xFF
    out[1::3] = ((i12 >> 8) & 0x0F) | ((q12 & 0x0F) << 4)
    out[2::3] = (q12 >> 4) & 0xFF
    return out


def test_wire_format_reaches_setup_stream(use_fake):
    # a device whose driver does NOT advertise CS12 rejects the request —
    # the -I format really reaches setupStream
    with pytest.raises(RuntimeError, match="setupStream failed"):
        soapy.SoapySource("driver=rtlsdr", wire_format="CS12")
    src = soapy.SoapySource("driver=rtlsdr,native=CS12", wire_format="CS12")
    try:
        assert src.wire_format == "CS12"
        assert src._stream
    finally:
        src.close()


@pytest.mark.parametrize("old", [False, True])
def test_cs12_wire_read_raw_and_cs16_contract(request, old):
    """Both setupStream ABIs deliver CS12 wire bytes; read_stream_raw
    returns them verbatim and read_stream unpacks bit-exactly
    (rtl_sdr.c:354-366)."""
    request.getfixturevalue("use_fake_old" if old else "use_fake")
    src = soapy.SoapySource("driver=rtlsdr,native=CS12", wire_format="CS12")
    try:
        src.activate()
        n, raw = src.read_stream_raw(512)
        assert n == 512 and raw.dtype == np.uint8 and raw.size == 3 * 512
        np.testing.assert_array_equal(raw, _cs12_ramp_bytes(0, 512))
        n2, cs16 = src.read_stream(512)
        assert n2 == 512 and cs16.dtype == np.int16
        expect = np.asarray(formats.cs12_to_cs16(_cs12_ramp_bytes(512, 512)))
        np.testing.assert_array_equal(cs16, expect)
    finally:
        src.close()


@pytest.mark.parametrize("fmt,dtype", [("CU8", np.uint8), ("CS8", np.int8),
                                       ("CF32", np.float32)])
def test_wire_formats_read_raw_and_cs16_contract(use_fake, fmt, dtype):
    """The other wire formats the fake serves: typed raw reads, and the
    CS16 contract through the port's codecs."""
    src = soapy.SoapySource(f"driver=rtlsdr,native={fmt}", wire_format=fmt)
    raw_src = soapy.SoapySource(f"driver=rtlsdr,native={fmt}",
                                wire_format=fmt)
    try:
        src.activate()
        raw_src.activate()
        n, raw = raw_src.read_stream_raw(300)
        assert n == 300 and raw.dtype == dtype and raw.size == 600
        n2, cs16 = src.read_stream(300)       # the same ramp, decoded
        assert n2 == 300 and cs16.dtype == np.int16
        np.testing.assert_array_equal(cs16, formats.convert(raw, fmt, "CS16"))
    finally:
        src.close()
        raw_src.close()


@pytest.mark.parametrize("in_fmt,out_fmt,n", [
    ("CS12", "CS16", 2048), ("CS12", "CS12", 2048), ("CU8", "CU8", 1024),
    ("CS8", "CS8", 1024), ("CF32", "CF32", 1000), ("CS16", "CU8", 3000),
    ("CS16", "CS12", 3000), ("CS16", "CF32", 3000),
])
def test_rx_sdr_dash_I_e2e_like_reference(both_packages, capfdbinary, in_fmt,
                                          out_fmt, n):
    """rx_sdr -I X -F Y against a fake radio that serves X on the wire:
    the raw-wire branch (passthrough, the bit-exact CS12 unpack) and the
    CS16 branch, byte for byte the reference CLI's, in both ABIs."""
    outs = []
    for main in (ref_rx_sdr.main, rx_sdr.main):
        rc = main(["-d", f"driver=rtlsdr,native={in_fmt}", "-f", "100M",
                   "-I", in_fmt, "-F", out_fmt, "-b", "1024", "-n", str(n),
                   "-"])
        assert rc == 0
        outs.append(capfdbinary.readouterr().out)
    assert outs[1] == outs[0]
    assert len(outs[1]) == n * formats.ELEM_BYTES[out_fmt]
    if (in_fmt, out_fmt) == ("CS12", "CS16"):
        expect = np.asarray(formats.cs12_to_cs16(_cs12_ramp_bytes(0, n)))
        np.testing.assert_array_equal(np.frombuffer(outs[1], np.int16), expect)
    if (in_fmt, out_fmt) == ("CU8", "CU8"):
        k = np.arange(n)
        arr = np.frombuffer(outs[1], np.uint8)
        np.testing.assert_array_equal(arr[0::2], (k & 0xFF).astype(np.uint8))
        np.testing.assert_array_equal(arr[1::2],
                                      (255 - (k & 0xFF)).astype(np.uint8))


def test_set_gain_mode_reaches_device(use_fake):
    """-E rtlagc routes through SoapySDRDevice_setGainMode (rtl_fm.c:1432),
    not a driver-private setting key."""
    src = soapy.SoapySource("driver=rtlsdr")
    try:
        assert src.set_gain_mode(True) == 0
        assert src.read_setting("fake_gain_mode") == "auto"
        assert src.set_gain_mode(False) == 0
        assert src.read_setting("fake_gain_mode") == "manual"
    finally:
        src.close()


def test_rx_fm_agc_flag_calls_set_gain_mode(use_fake, monkeypatch, tmp_path):
    """rx_fm -E agc reaches the device via setGainMode; without the flag
    the mode is still set (to manual), matching the reference's
    unconditional call (rtl_fm.c:1432).  The fake never ends its stream,
    so --blocks ends the run."""
    calls = []
    orig_sgm = soapy.SoapySource.set_gain_mode

    def spy(self, automatic):
        calls.append(bool(automatic))
        return orig_sgm(self, automatic)

    monkeypatch.setattr(soapy.SoapySource, "set_gain_mode", spy)
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    out = tmp_path / "a.pcm"
    assert rx_fm.main(["-f", "100M", "-M", "fm", "-d", "driver=rtlsdr",
                       "-E", "agc", "--blocks", "3", str(out)]) == 0
    assert calls == [True]
    assert out.stat().st_size > 0
    calls.clear()
    assert rx_fm.main(["-f", "100M", "-M", "fm", "-d", "driver=rtlsdr",
                       "--blocks", "3", str(out)]) == 0
    assert calls == [False]


def test_rx_fm_from_fake_device_matches_reference_cli(both_packages,
                                                      tmp_path):
    """rx_fm -M wbfm from the fake device, ended by --blocks: the port's
    PCM against the reference CLI's (same count, at most 1 LSB)."""
    pcms = []
    for main in (ref_rx_fm.main, rx_fm.main):
        out = tmp_path / f"a{len(pcms)}.raw"
        assert main(["-f", "100.3M", "-M", "wbfm", "-b", "4", "-d",
                     "driver=rtlsdr", "--blocks", "8", str(out)]) == 0
        pcms.append(np.fromfile(out, np.int16))
    want, pcm = pcms
    assert pcm.size == want.size > 2000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1
