"""The port's hardware soak (``python -m rx_tools_tpu_torch.hw_soak``)
against the reference's ``tools/hw_soak.py``: the exit codes (2 with no
radio, 0 on a live FM recording served by rtl_tcp, 1 on a dead stream),
its CLIs run on the CPU (``RX_PLATFORM=cpu`` in the subprocess
environment), and the two scripts' checks giving the same verdicts on the
same files, so that their thresholds cannot drift apart."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rx_tools_tpu_torch import hw_soak
from rx_tools_tpu_torch.apps import rx_sdr
from test_torch_rtltcp import MockRtlTcpServer

ROOT = Path(__file__).resolve().parents[1]
STATION = 100.3e6
#: where rx_fm -M wbfm tunes for STATION at 2.4 Msps (+fs/4, +16 kHz)
TUNE = STATION + 2.4e6 / 4 + 16e3
#: the recording's span, narrowed from the FM broadcast band
BAND = "99.8M:102M:10k"


def _soak(*args, prelude="", timeout=240):
    """Run the soak in a subprocess on the CPU; (exit code, its lines)."""
    env = dict(os.environ, RX_PLATFORM="cpu")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    code = (prelude + "from rx_tools_tpu_torch import hw_soak\n"
            f"raise SystemExit(hw_soak.main({list(args)!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, [line for line in p.stderr.splitlines()
                          if line.startswith("[hw_soak]")]


@pytest.fixture(scope="module")
def fm_cu8(tmp_path_factory):
    """0.25 s of a synth FM station recorded by rx_sdr at 2.4 Msps, CU8,
    tuned as rx_fm -M wbfm tunes for it (BASELINE config #1)."""
    path = tmp_path_factory.mktemp("soak") / "cfg1.cu8"
    assert rx_sdr.main([
        "-f", f"{TUNE:.0f}", "-s", "2.4M", "-d",
        "synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,seed=7,"
        f"carrier={STATION:.0f}", "-n", "600000", "-F", "CU8",
        str(path)]) == 0
    return path.read_bytes()


def _against_mock(payload):
    """The soak against an rtl_tcp server that serves ``payload`` to each
    of its two clients (rx_fm, then rx_power)."""
    srv = MockRtlTcpServer(payload, connections=2)
    rc, lines = _soak("--rtltcp", f"127.0.0.1:{srv.port}", "--fm-freq",
                      f"{STATION:.0f}", "--band", BAND, "--seconds", "200")
    srv.join()
    return rc, lines, srv.commands


def test_no_source_exits_2():
    """No ``--rtltcp``/``--driver`` and no SoapySDR library: nothing to
    soak."""
    rc, lines = _soak(prelude="from rx_tools_tpu_torch.iq import soapy\n"
                      "soapy._LIB, soapy._TRIED = None, True\n")
    assert rc == 2, lines
    assert any("no SoapySDR hardware" in line for line in lines)
    assert lines[-1] == ("[hw_soak] no hardware source available — nothing "
                         "to soak (exit 2)")


def test_live_recording_over_rtltcp_passes(fm_cu8):
    """The recording repeated to 1.25 s (rx_fm reads it as a 1.02 Msps
    capture, so ~2.9 s of audio): live audio, a sweep over the band with
    a station in it, exit 0; rx_fm tuned the server."""
    rc, lines, commands = _against_mock(fm_cu8 * 5)
    assert rc == 0, lines
    assert lines[-1] == "[hw_soak] PASS"
    assert any(line.startswith("[hw_soak] audio: ") for line in lines)
    assert any(line.startswith("[hw_soak] sweep: ") for line in lines)
    # rx_fm -M wbfm plans 1.02 Msps: the station +16 kHz +fs/4
    assert (1, round(STATION + 16e3 + 1.02e6 / 4)) in commands


def test_dead_stream_fails(fm_cu8):
    """A constant stream (zero I/Q): silent audio, a flat sweep: exit 1."""
    rc, lines, _ = _against_mock(b"\x80" * len(fm_cu8) * 5)
    assert rc == 1, lines
    assert lines[-1] == "[hw_soak] FAIL"
    assert any("FAIL: audio RMS" in line for line in lines)


def _reference_soak():
    spec = importlib.util.spec_from_file_location(
        "reference_hw_soak", ROOT / "tools" / "hw_soak.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pcm(tmp_path, name, samples):
    path = tmp_path / f"{name}.pcm"
    np.asarray(samples, np.int16).tofile(path)
    return str(path)


def _csv(tmp_path, name, lo, hi, dbs):
    """rx_power rows: date, time, lo, hi, step, samples, dB..."""
    path = tmp_path / f"{name}.csv"
    edges = np.linspace(lo, hi, len(dbs) + 1)
    with open(path, "w") as f:
        for a, b, row in zip(edges[:-1], edges[1:], dbs):
            cells = ["2026-01-01", "00:00:00", f"{a:.0f}", f"{b:.0f}",
                     "10000.00", "8192"] + [f"{v:.2f}" for v in row]
            f.write(", ".join(cells) + "\n")
    return str(path)


def test_checks_give_the_reference_verdicts(tmp_path):
    ref = _reference_soak()
    rng = np.random.default_rng(4)
    t = np.arange(3 * 32000) / 32000
    tone = 6000 * np.sin(2 * np.pi * 1000 * t) + rng.normal(0, 50, t.size)
    pcms = {"live": (_pcm(tmp_path, "live", tone), True),
            "dead": (_pcm(tmp_path, "dead", np.zeros(t.size)), False),
            "short": (_pcm(tmp_path, "short", tone[:16000]), False)}
    for name, (path, want) in pcms.items():
        assert bool(ref.check_fm_audio(path)) is want, name
        assert bool(hw_soak.check_fm_audio(path)) is want, name
    lo, hi = 99.8e6, 102e6
    live = rng.normal(-60, 3, (2, 64))
    live[0, 20] = -20.0
    csvs = {"live": (_csv(tmp_path, "live", lo, hi, live), True),
            "flat": (_csv(tmp_path, "flat", lo, hi,
                          rng.normal(-60, 1, (2, 64)).clip(-63, -57)),
                     False),
            "narrow": (_csv(tmp_path, "narrow", lo, 100.5e6, live), False)}
    for name, (path, want) in csvs.items():
        assert bool(ref.check_power_csv(path, lo, hi)) is want, name
        assert bool(hw_soak.check_power_csv(path, lo, hi)) is want, name
