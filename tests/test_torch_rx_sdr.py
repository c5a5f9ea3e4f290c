"""The port's rx_sdr CLI against the reference CLI: every allowed format
pair from the synth and from files, ``-n``, the refusals; then rx_fm and
rx_power in the port reading CS8, CS12 and CF32 files and a fake
``driver=`` device, held to the reference CLIs at the existing classes
(rx_fm: the same PCM count and at most 1 LSB; rx_power: CSV columns 2-5
identical, dB within 0.02 wherever the reference lies within 60 dB of its
row's peak, ``-inf`` alike)."""

import ctypes
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.apps import rx_power as ref_rx_power
from rx_tools_tpu.apps import rx_sdr as ref_rx_sdr
from rx_tools_tpu.iq import soapy as ref_soapy
from rx_tools_tpu_torch.apps import rx_fm, rx_power, rx_sdr
from rx_tools_tpu_torch.iq import formats, soapy

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).parent
SYNTH = "synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,carrier=100.3M"
POWER_SRC = "synth=tone,seed=2,carrier=101M,amp=0.4,noise=0.02"
DB_TOL, DB_RANGE = 0.02, 60.0

ALLOWED = ([(f, f) for f in formats.FORMATS]
           + [("CS16", f) for f in formats.FORMATS if f != "CS16"]
           + [("CS12", "CS16")])
REFUSED = [("CU8", "CS16"), ("CS8", "CU8"), ("CF32", "CS16"),
           ("CS12", "CU8")]


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


def _both_sdr(args, tmp_path, tag=""):
    """The same rx_sdr flags through both CLIs: (port bytes, ref bytes)."""
    ref, port = tmp_path / f"ref{tag}", tmp_path / f"port{tag}"
    assert ref_rx_sdr.main(args + [str(ref)]) == 0
    assert rx_sdr.main(args + [str(port)]) == 0
    return port.read_bytes(), ref.read_bytes()


def _record(tmp_path, fmt, n=20000, query=SYNTH, rate="1020k",
            freq="100.555M"):
    """A capture of ``n`` complex samples in ``fmt``, recorded with the
    port's rx_sdr (the station at -fs/4 of the centre, as rx_fm tunes)."""
    path = tmp_path / f"cap.{fmt.lower()}"
    assert rx_sdr.main(["-f", freq, "-s", rate, "-d", query, "-n", str(n),
                        "-F", fmt, str(path)]) == 0
    return path


@pytest.mark.parametrize("in_fmt,out_fmt", ALLOWED,
                         ids=[f"{i}-{o}" for i, o in ALLOWED])
def test_pair_from_synth_matches_reference(in_fmt, out_fmt, tmp_path):
    """The synth delivers CS16 whatever -I says (no raw wire)."""
    got, want = _both_sdr(["-f", "100M", "-s", "2.4M", "-d", SYNTH, "-n",
                           "30000", "-b", "8192", "-I", in_fmt, "-F",
                           out_fmt], tmp_path)
    assert got == want
    assert len(got) == 30000 * formats.ELEM_BYTES[out_fmt]


@pytest.mark.parametrize("in_fmt,out_fmt", ALLOWED,
                         ids=[f"{i}-{o}" for i, o in ALLOWED])
def test_pair_from_file_matches_reference(in_fmt, out_fmt, tmp_path):
    """-I decodes the file (rtl_sdr.c:138,301): its bytes are widened to
    CS16 and narrowed to -F, as the reference CLI does."""
    cap = _record(tmp_path, in_fmt, n=12345)
    got, want = _both_sdr(["-f", "100M", "-d", f"file={cap}", "-I", in_fmt,
                           "-F", out_fmt], tmp_path)
    assert got == want
    assert len(got) == 12345 * formats.ELEM_BYTES[out_fmt]
    if in_fmt in ("CS12", "CS16") and out_fmt == "CS16":
        np.testing.assert_array_equal(
            np.frombuffer(got, np.int16),
            formats.convert(formats.bytes_to_array(cap.read_bytes(), in_fmt),
                            in_fmt, "CS16"))


def test_format_pinned_by_query_wins_over_dash_I(tmp_path):
    cap = _record(tmp_path, "CS8", n=5000)
    got, want = _both_sdr(["-d", f"file={cap},format=CS8", "-I", "CS16",
                           "-F", "CF32"], tmp_path)
    assert got == want and len(got) == 5000 * 8


def test_stdin_source_takes_dash_I(tmp_path, monkeypatch):
    cap = _record(tmp_path, "CU8", n=7000)
    outs = []
    for main in (ref_rx_sdr.main, rx_sdr.main):
        class _Stdin:
            buffer = io.BytesIO(cap.read_bytes())
        monkeypatch.setattr(sys, "stdin", _Stdin)
        out = tmp_path / f"o{len(outs)}"
        assert main(["-d", "stdin", "-I", "CU8", "-F", "CU8", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[1] == outs[0] and len(outs[1]) == 2 * 7000


@pytest.mark.parametrize("n,block", [(1000, 8192), (4097, 2048),
                                     (8192, 2048), (1, 16)])
def test_dash_n_truncates_in_components(n, block, tmp_path):
    """-n counts complex samples; the reference keeps n_read in components
    (rtl_sdr.c:341-346)."""
    got, want = _both_sdr(["-d", SYNTH, "-n", str(n), "-b", str(block),
                           "-F", "CS16"], tmp_path)
    assert got == want and len(got) == 4 * n


@pytest.mark.parametrize("in_fmt,out_fmt", REFUSED,
                         ids=[f"{i}-{o}" for i, o in REFUSED])
def test_unsupported_pair_exits_1(in_fmt, out_fmt, tmp_path, capsys):
    out = tmp_path / "x"
    for main in (ref_rx_sdr.main, rx_sdr.main):
        assert main(["-d", SYNTH, "-I", in_fmt, "-F", out_fmt,
                     str(out)]) == 1
        assert "Unsupported input/output format conversion" in \
            capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("argv", [["-d", SYNTH], ["-q", "x", "out"]],
                         ids=["no-filename", "bad-flag"])
def test_usage_exit(argv, capsys):
    for main in (ref_rx_sdr.main, rx_sdr.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 1
        assert "Usage:" in capsys.readouterr().err


def test_unknown_format_raises_like_reference():
    for main in (ref_rx_sdr.main, rx_sdr.main):
        with pytest.raises(ValueError, match="Unsupported format: CF64"):
            main(["-F", "CF64", "out"])


def test_stdout_output(tmp_path, capfdbinary):
    outs = []
    for main in (ref_rx_sdr.main, rx_sdr.main):
        assert main(["-d", SYNTH, "-n", "3000", "-F", "CS8", "-"]) == 0
        outs.append(capfdbinary.readouterr().out)
    assert outs[1] == outs[0] and len(outs[1]) == 6000


# --- rx_fm and rx_power reading the new wire formats ---------------------

def _pcm_pair(args, tmp_path):
    out_ref, out = tmp_path / "ref.raw", tmp_path / "port.raw"
    assert ref_rx_fm.main(args + [str(out_ref)]) == 0
    assert rx_fm.main(args + [str(out)]) == 0
    return np.fromfile(out, np.int16), np.fromfile(out_ref, np.int16)


def _tone_hz(pcm, rate=32000):
    a = pcm[1000:].astype(np.float64)
    a -= a.mean()
    sp = np.abs(np.fft.rfft(a * np.hanning(a.size))) ** 2
    return np.fft.rfftfreq(a.size, 1 / rate)[np.argmax(sp)]


@pytest.mark.parametrize("fmt", ["CS8", "CS12", "CF32"])
def test_rx_fm_reads_format_like_reference(fmt, tmp_path):
    cap = _record(tmp_path, fmt, n=17 * 8208)
    pcm, want = _pcm_pair(["-f", "100.3M", "-M", "wbfm", "-b", "4", "-d",
                           f"file={cap},format={fmt},rate=1020k"], tmp_path)
    assert pcm.size == want.size > 4000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1
    assert abs(_tone_hz(pcm) - 1000.0) < 20


def _rows(path):
    with open(path) as f:
        return [line.strip().split(", ")[2:] for line in f]


def assert_float_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4]                     # Hz low/high/step, samples
        assert len(g) == len(w)
        gd, wd = np.array(g[4:], float), np.array(w[4:], float)
        assert (np.isneginf(gd) == np.isneginf(wd)).all()
        fin = np.isfinite(wd)
        near = fin & (wd >= wd[fin].max(initial=-np.inf) - DB_RANGE)
        assert np.abs(gd[near] - wd[near]).max(initial=0) <= DB_TOL


def _power_pair(args, tmp_path):
    """Both CLIs (the reference on one device, ``-t 1``): CSV rows."""
    ref, port = tmp_path / "ref.csv", tmp_path / "port.csv"
    assert ref_rx_power.main(args + ["-t", "1", str(ref)]) == 0
    assert rx_power.main(args + [str(port)]) == 0
    return _rows(port), _rows(ref)


@pytest.mark.parametrize("fmt", ["CS8", "CS12", "CF32"])
@pytest.mark.parametrize("int_fft", [False, True], ids=["float", "int-fft"])
def test_rx_power_reads_format_like_reference(fmt, int_fft, tmp_path):
    """A two-hop sweep over a file of the format (a file ignores retunes:
    each hop reads on through it)."""
    cap = _record(tmp_path, fmt, n=80000, query=POWER_SRC, rate="2.4M",
                  freq="101M")
    got, want = _power_pair(["-f", "100M:104M:50k", "-1", "-S", "0", "-d",
                             f"file={cap},format={fmt}"]
                            + (["--int-fft"] if int_fft else []), tmp_path)
    if int_fft:
        assert got == want
    else:
        assert_float_rows(got, want)
    assert len(got) == 2


@pytest.fixture(scope="module")
def fake_soapy(tmp_path_factory):
    out = tmp_path_factory.mktemp("fakesoapy") / "libfakesoapy.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", str(out),
                    str(HERE / "fake_soapy.cpp")], check=True,
                   capture_output=True)
    return out


@pytest.fixture
def fake_device(fake_soapy, monkeypatch):
    """The fake libSoapySDR installed in both packages."""
    for module in (soapy, ref_soapy):
        lib = ctypes.CDLL(str(fake_soapy))
        module._bind(lib)
        monkeypatch.setattr(module, "_LIB", lib)
        monkeypatch.setattr(module, "_TRIED", True)


def test_rx_fm_from_fake_device_like_reference(fake_device, tmp_path):
    """The fake never ends its stream: --blocks ends the run."""
    pcm, want = _pcm_pair(["-f", "100M", "-M", "fm", "-s", "24k", "-d",
                           "driver=rtlsdr,native=CS16", "--blocks", "6"],
                          tmp_path)
    assert pcm.size == want.size > 1000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("int_fft", [False, True], ids=["float", "int-fft"])
def test_rx_power_from_fake_device_like_reference(fake_device, int_fft,
                                                  tmp_path):
    got, want = _power_pair(["-f", "100M:104M:50k", "-1", "-S", "0", "-d",
                             "driver=rtlsdr"]
                            + (["--int-fft"] if int_fft else []), tmp_path)
    if int_fft:
        assert got == want
    else:
        assert_float_rows(got, want)
    assert len(got) == 2


def test_rx_sdr_from_fake_device_like_reference(fake_device, tmp_path):
    """The fake device through rx_sdr, ended by -n, gain elements set."""
    got, want = _both_sdr(["-d", "driver=hackrf", "-g", "LNA=16,VGA=8",
                           "-n", "5000", "-F", "CU8", "-t", "biastee=1"],
                          tmp_path)
    assert got == want and len(got) == 2 * 5000
