"""The port's examples (``rx_tools_tpu_torch/examples``) against the
reference package's (``examples/``), on the CPU."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from rx_tools_tpu_torch.examples import multichannel_fm, scan_and_demod

torch.set_num_threads(2)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


def _reference(name):
    """The reference package's example module, imported from examples/."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(EXAMPLES))


def _peak_hz(path, fs=32000):
    a = np.fromfile(path, np.int16).astype(np.float64)
    assert a.size > 4000, (path, a.size)
    a = a[a.size // 4:]
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    return np.fft.rfftfreq(a.size, 1.0 / fs)[np.argmax(spec[1:]) + 1]


def test_scan_and_demod_two_stations(tmp_path):
    """The two-station scene of tests/test_scan_and_demod.py:26-37: the
    same station list as the reference example, both tones back."""
    scene = ("synth=fm,carrier=100.2M|100.75M,audio=1k|440,"
             "dev=50k|50k,amp=0.6|0.6,noise=0.005")
    ref = _reference("scan_and_demod")
    assert ref.main(["100M:101M", scene, str(tmp_path / "ref")]) == 0
    out = tmp_path / "port"
    assert scan_and_demod.main(["100M:101M", scene, str(out)]) == 0
    got = scan_and_demod.find_stations(str(tmp_path / "port_scan.csv"))
    want = ref.find_stations(str(tmp_path / "ref_scan.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e3)
    files = sorted(out.glob("ch*.s16"))
    assert len(files) == 2
    peaks = sorted(_peak_hz(f) for f in files)
    assert abs(peaks[0] - 440.0) < 20 and abs(peaks[1] - 1000.0) < 20


def test_find_stations_peak_picking(tmp_path):
    """tests/test_scan_and_demod.py:40-52's hand-written CSV, in both."""
    csv = tmp_path / "s.csv"
    row = ["-20"] * 100
    row[30], row[31], row[70] = "5", "3", "2"
    csv.write_text("2026-08-18, 10:00:00, 100000000, 101000000, 10000, 32, "
                   + ", ".join(row) + "\n")
    st = scan_and_demod.find_stations(str(csv), min_snr_db=10, min_sep=150e3)
    assert st == _reference("scan_and_demod").find_stations(
        str(csv), min_snr_db=10, min_sep=150e3)
    assert len(st) == 2
    assert abs(st[0] - (100e6 + 30.5 * 10e3)) < 5e3
    assert abs(st[1] - (100e6 + 70.5 * 10e3)) < 5e3


def test_usage_exits_1():
    assert scan_and_demod.main([]) == 1
    assert multichannel_fm.main([]) == 1


def test_multichannel_fm_matches_reference(tmp_path, monkeypatch):
    """Two stations in a CS16 capture: the same station files as the
    reference example, PCM within 1 LSB, both tones back."""
    from rx_tools_tpu_torch.apps import rx_sdr
    cap = tmp_path / "cap.cs16"
    assert rx_sdr.main(["-d", "synth=fm,det=1,carrier=100.2M|100.5M,"
                        "audio=1k|440,dev=15k|15k,amp=0.4|0.4", "-f",
                        "100.35M", "-s", "1024k", "-n", "600000", "-F", "CS16",
                        str(cap)]) == 0
    argv = [str(cap), "1024k", "100.2M,100.5M"]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    assert _reference("multichannel_fm").main(argv) == 0
    monkeypatch.chdir(tmp_path / "port")
    assert multichannel_fm.main(argv) == 0
    got = sorted((tmp_path / "port").glob("station_*.raw"))
    want = sorted((tmp_path / "ref").glob("station_*.raw"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 2
    for g, w in zip(got, want):
        x = np.fromfile(g, np.int16).astype(int)
        y = np.fromfile(w, np.int16).astype(int)
        assert x.size == y.size > 4000 and np.abs(x - y).max() <= 1, g.name
    assert abs(_peak_hz(got[0]) - 1000.0) < 20
    assert abs(_peak_hz(got[1]) - 440.0) < 20
