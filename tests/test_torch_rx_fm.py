"""The port's rx_fm CLI against the reference CLI on the same CS16 capture
(modelled on tests/test_apps.py:60-80), and its sources against the
reference's."""

import json

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.iq import sources as ref_sources
from rx_tools_tpu_torch.apps import rx_fm
from rx_tools_tpu_torch.iq import sources

torch.set_num_threads(2)

SYNTH = "synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,carrier=100.3M"


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


def _capture(n, rate=1_020_000, tune=100.555e6):
    """A WBFM capture with the station at -fs/4 of the file centre, so the
    chain's derotation recentres it (as tests/test_apps.py records it)."""
    src = sources.make_source(SYNTH)
    src.set_sample_rate(rate)
    src.set_frequency(tune)
    got, iq = src.read_stream(n)
    assert got == n
    return iq


def test_synth_source_matches_reference():
    for query in (SYNTH, "synth=tone,amp=0.3", "synth=noise,seed=4"):
        a, b = sources.make_source(query), ref_sources.make_source(query)
        for s in (a, b):
            s.set_sample_rate(1_020_000)
            s.set_frequency(100.555e6)
        for n in (1000, 4096):
            np.testing.assert_array_equal(a.read_stream(n)[1],
                                          b.read_stream(n)[1])


def test_rx_fm_wbfm_matches_reference_cli(tmp_path):
    cap = tmp_path / "cap.cs16"
    _capture(17 * 8208).tofile(cap)
    args = ["-f", "100.3M", "-M", "wbfm", "-b", "8",
            "-d", f"file={cap},format=CS16,rate=1020k"]
    out_ref, out = tmp_path / "ref.raw", tmp_path / "port.raw"
    assert ref_rx_fm.main(args + [str(out_ref)]) == 0
    assert rx_fm.main(args + [str(out)]) == 0
    want = np.fromfile(out_ref, np.int16)
    pcm = np.fromfile(out, np.int16)
    assert pcm.size == want.size > 4000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1
    a = pcm[1000:].astype(np.float64)
    a -= a.mean()
    sp = np.abs(np.fft.rfft(a * np.hanning(a.size))) ** 2
    fr = np.fft.rfftfreq(a.size, 1 / 32000)
    assert abs(fr[np.argmax(sp)] - 1000.0) < 20


@pytest.mark.parametrize("flags,name", [(["-E", "shard"], "-E shard")])
def test_unported_flags_exit_1(flags, name, capsys, tmp_path, monkeypatch):
    """Once refused, now served: ``-E shard`` on the reference's 8 CPU
    devices (a capture shorter than one super-chunk takes the one-device
    tail replay) gives the reference CLI's PCM within 1 LSB."""
    monkeypatch.setenv("JAX_NUM_CPU_DEVICES", "8")
    cap = tmp_path / "cap.cs16"
    _capture(17 * 8208).tofile(cap)
    args = ["-f", "100.3M", "-M", "wbfm",
            "-d", f"file={cap},format=CS16,rate=1020k"] + flags
    out_ref, out = tmp_path / "ref.raw", tmp_path / "out.raw"
    assert ref_rx_fm.main(args + [str(out_ref)]) == 0
    assert rx_fm.main(args + [str(out)]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    want = np.fromfile(out_ref, np.int16)
    pcm = np.fromfile(out, np.int16)
    assert pcm.size == want.size > 2000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("flags", [
    ["--int-audio"],
    ["--checkpoint", "ck.npz"],
    ["--resume", "ck.npz"],
    ["-b", "1"],
    ["-F", "9"],
    ["-E", "hq"],
    ["-E", "rdc"],
    ["-l", "40", "-f", "101M"],
], ids=["int-audio", "checkpoint", "resume", "b1", "F9", "hq", "rdc",
        "scanning"])
def test_flag_matches_reference_cli(flags, tmp_path):
    """Each flag once refused is now served: the port's CLI bytes against
    the reference CLI's on one capture — identical for --int-audio, the
    same count and at most 1 LSB apart for the float chain."""
    cap = tmp_path / "cap.cs16"
    _capture(17 * 8208).tofile(cap)
    args = ["-f", "100.3M", "-M", "wbfm", "-b", "4",
            "-d", f"file={cap},format=CS16,rate=1020k"]
    flags = [str(tmp_path / f) if f.endswith(".npz") else f for f in flags]
    out_ref, out = tmp_path / "ref.raw", tmp_path / "port.raw"
    assert ref_rx_fm.main(args + flags + [str(out_ref)]) == 0
    for f in tmp_path.glob("*.npz"):
        f.unlink()
    assert rx_fm.main(args + flags + [str(out)]) == 0
    want = np.fromfile(out_ref, np.int16)
    pcm = np.fromfile(out, np.int16)
    assert pcm.size == want.size > 2000
    if flags == ["--int-audio"]:
        np.testing.assert_array_equal(pcm, want)
    else:
        assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1
    if "--checkpoint" in flags:
        assert (tmp_path / "ck.npz").exists()


def test_rx_fm_scan_requires_squelch():
    assert rx_fm.main(["-f", "100M", "-f", "101M"]) == 1


@pytest.mark.parametrize("flags,synth,rate", [
    # BASELINE config #2: -s 96k -F 9 resolves D = 16 (4 passes), 1.536M
    (["-f", "100M", "-M", "nbfm", "-s", "96k", "-r", "48k", "-F", "9",
      "-l", "10"], "synth=fm,audio=800,dev=5k,amp=0.8,carrier=100M",
     1_536_000),
    # BASELINE config #3: -s 24k, D = 42 at 1.008M, offset tuning; and rdc
    (["-f", "100M", "-M", "am", "-s", "24k", "-E", "dc", "-E", "offset"],
     "synth=am,audio=600,amp=0.5,carrier=100.002M", 1_008_000),
    (["-f", "100M", "-M", "am", "-s", "24k", "-E", "dc", "-E", "offset",
      "-E", "rdc"], "synth=am,audio=600,amp=0.5,carrier=100.002M",
     1_008_000),
], ids=["config2", "config3", "config3-rdc"])
def test_baseline_config_matches_reference_cli(flags, synth, rate, tmp_path):
    """BASELINE configs #2 and #3 through both CLIs on one capture: the
    same PCM count, at most 1 LSB apart."""
    src = sources.make_source(synth)
    src.set_sample_rate(rate)
    src.set_frequency(100e6 + (0 if "offset" in flags else rate / 4))
    cap = tmp_path / "cap.cs16"
    src.read_stream(24 * 8232)[1].tofile(cap)
    args = flags + ["-d", f"file={cap},format=CS16,rate={rate}"]
    out_ref, out = tmp_path / "ref.raw", tmp_path / "port.raw"
    assert ref_rx_fm.main(args + [str(out_ref)]) == 0
    assert rx_fm.main(args + [str(out)]) == 0
    want = np.fromfile(out_ref, np.int16)
    pcm = np.fromfile(out, np.int16)
    assert pcm.size == want.size > 2000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1


def test_rx_profile_writes_a_trace(tmp_path, monkeypatch):
    """RX_PROFILE=<dir> wraps the run in a torch.profiler trace (the JAX
    CLI's jax.profiler hook, apps/common.py:48-68), written into <dir>."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("RX_PROFILE", str(prof))
    out = tmp_path / "o.raw"
    assert rx_fm.main(["-f", "100.3M", "-M", "wbfm", "-d", SYNTH,
                       "--blocks", "4", str(out)]) == 0
    assert out.stat().st_size > 0
    traces = list(prof.glob("rx_trace.*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
