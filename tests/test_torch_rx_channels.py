"""The port's rx_channels CLI against the reference CLI, on the CPU, at
the reference tests' geometries (1.024 Msps, ``-n 16``, ``-k`` with ``-D
16``; tests/test_rx_channels.py): the same file names, the same sample
count in every channel and, for the same engine, PCM within 1 LSB on
every channel (the float-chain bar of tools/tpu_e2e.py)."""

import time

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_channels as ref_rx_channels
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.apps import rx_channels

torch.set_num_threads(2)

PFB_SRC = ("synth=fm,det=1,seed=7,carrier=100.192M,audio=1k,dev=15k,"
           "amp=0.8")
MIX_SRC = ("synth=fm,det=1,seed=7,carrier=100.2M|100.35M,audio=1k|440,"
           "dev=15k|15k,amp=0.5|0.3")
BASE = ["-f", "100M", "-s", "1024k"]
# an FM carrier at every -n 16 channel's centre: no channel holds only
# noise, whose discriminator output is chaotic (tests/test_channelizer.py:93-96)
GRID_SRC = ("synth=fm,det=1,seed=3,audio=1k,dev=10k,amp=0.05,carrier="
            + "|".join(str(100_000_000 + k * 64_000) for k in range(-8, 8)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


def _files(out):
    return sorted(out.glob("ch*.s16"))


def _pcm(path):
    return np.fromfile(path, np.int16).astype(np.int64)


def _peak_hz(path, fs=32000):
    a = _pcm(path).astype(np.float64)
    assert a.size > 4000, path
    a = a[a.size // 4:]
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    return np.fft.rfftfreq(a.size, 1.0 / fs)[np.argmax(spec[1:]) + 1]


def _both(args, tmp_path, tag="", port_extra=()):
    """The same flags through the reference CLI and the port's; returns
    both runs' channel files (the names checked equal)."""
    ref, port = tmp_path / f"ref{tag}", tmp_path / f"port{tag}"
    assert ref_rx_channels.main(args + [str(ref)]) == 0
    assert rx_channels.main(args + list(port_extra) + [str(port)]) == 0
    fr, fp = _files(ref), _files(port)
    assert [p.name for p in fp] == [p.name for p in fr] and fr
    return fp, fr


def _within(fp, fr, lsb=1, min_size=1000):
    for a, b in zip(fp, fr):
        x, y = _pcm(a), _pcm(b)
        assert x.size == y.size >= min_size, a.name
        assert np.abs(x - y).max() <= lsb, (a.name, np.abs(x - y).max())


@pytest.mark.parametrize("engine", ["tmaj", "cm"])
def test_pfb_matches_reference_cli(engine, tmp_path, monkeypatch):
    """``-n 16`` in each engine (``RX_PFB``), the 1 kHz tone on the
    station's channel."""
    if engine == "cm":
        monkeypatch.setenv("RX_PFB", "cm")
    fp, fr = _both(BASE + ["-n", "16", "-M", "fm", "-A", "fast", "-c", "us",
                           "-r", "32k", "-e", "1", "-d", PFB_SRC], tmp_path)
    assert len(fp) == 16
    _within(fp, fr)
    station = [p for p in fp if "_100192000" in p.name]
    assert len(station) == 1 and abs(_peak_hz(station[0]) - 1000.0) < 30


@pytest.mark.parametrize("engine", ["tmaj", "cm"])
def test_mixer_matches_reference_cli(engine, tmp_path, monkeypatch):
    """``-k`` with ``-D 16`` in each engine (``RX_MIXER``), both tones
    back."""
    if engine == "cm":
        monkeypatch.setenv("RX_MIXER", "cm")
    fp, fr = _both(BASE + ["-k", "100.2M,100.35M", "-D", "16", "-M", "fm",
                           "-A", "std", "-c", "off", "-r", "32k", "-e", "1",
                           "-d", MIX_SRC], tmp_path)
    assert len(fp) == 2
    _within(fp, fr)
    assert abs(_peak_hz(fp[0]) - 1000.0) < 30
    assert abs(_peak_hz(fp[1]) - 440.0) < 30


@pytest.mark.parametrize("mode", ["am", "usb", "lsb", "raw"])
@pytest.mark.parametrize("engine", ["-n", "-k"])
def test_modes_match_reference_cli(engine, mode, tmp_path):
    """Every mode through both channelizers (raw runs channel-major in
    both CLIs), 0.25 s of signal."""
    sel = (["-n", "16"] if engine == "-n"
           else ["-k", "100.2M,100.35M", "-D", "16"])
    r = ["-r", "0"] if mode in ("usb", "raw") else ["-r", "32k"]
    fp, fr = _both(BASE + sel + ["-M", mode, "-e", "0.25", "-d", MIX_SRC]
                   + r, tmp_path)
    _within(fp, fr)


def test_every_flag(tmp_path):
    """The device flags (-g -p -a), -b, -c eu, -r 24k and -t: the port logs
    ``-t 2`` and runs on its one device (the reference gets no ``-t``: it
    would shard onto its channel-major engine)."""
    args = BASE + ["-n", "16", "-M", "fm", "-A", "fast", "-c", "eu", "-r",
                   "24k", "-b", "65536", "-e", "0.5", "-g", "20", "-p", "1",
                   "-a", "RX", "-d", GRID_SRC]
    fp, fr = _both(args, tmp_path, port_extra=["-t", "2"])
    _within(fp, fr)


def test_validation_exit_codes():
    assert rx_channels.main(["-f", "100M", "-n", "8", "-k", "100M", "x"]) == 1
    assert rx_channels.main(["-f", "100M", "-s", "1024k", "-k", "101M",
                             "x"]) == 1          # outside the capture band
    assert rx_channels.main(["-f", "100M", "-n", "8", "-M", "wbfm",
                             "x"]) == 1          # unknown mode
    with pytest.raises(SystemExit):
        rx_channels.main([])                     # no outdir / freq
    with pytest.raises(SystemExit):
        rx_channels.main(["-f", "100M", "-Z"])   # unknown flag


def test_partial_tail_matches_reference(tmp_path):
    """A capture of 1.5 blocks keeps its tail (zero-padded, trimmed by
    ``round(n_valid * valid / block)``), in both CLIs alike."""
    from rx_tools_tpu_torch.apps import rx_sdr
    fs, blk = 1_024_000, 131072
    cap = tmp_path / "cap.cs16"
    assert rx_sdr.main(["-d", "synth=fm,carrier=100.2M,audio=1k,dev=15k,"
                        "amp=0.8", "-f", "100M", "-s", str(fs), "-n",
                        str(blk + blk // 2), "-F", "CS16", str(cap)]) == 0
    fp, fr = _both(["-f", "100M", "-s", str(fs), "-k", "100.2M", "-D", "16",
                    "-M", "fm", "-A", "std", "-c", "off", "-r", "0", "-b",
                    str(blk), "-d", f"file={cap},format=CS16,rate={fs}"],
                   tmp_path)
    _within(fp, fr)
    assert _pcm(fp[0]).size > 11000      # 12288 = 1.5 blocks at 64 kHz


def test_deemph_alpha_uses_channel_rate(tmp_path, monkeypatch):
    captured = {}
    real_cfg = rx_channels.channelizer.ChannelizerConfig

    def spy(*a, **kw):
        cfg = real_cfg(*a, **kw)
        captured["deemph_a"] = cfg.deemph_a
        return cfg

    monkeypatch.setattr(rx_channels.channelizer, "ChannelizerConfig", spy)
    assert rx_channels.main([
        "-f", "100M", "-s", "2400k", "-k", "100.3M", "-D", "16", "-r", "32k",
        "-c", "us", "-e", "0.05", "-d",
        "synth=fm,carrier=100.3M,audio=1k,dev=15k,amp=0.5",
        str(tmp_path / "o")]) == 0
    assert captured["deemph_a"] == ops.deemph_alpha(2_400_000 // 16, 75)


def test_pfb_tmaj_against_channel_major(tmp_path, monkeypatch):
    """The time-major default against ``RX_PFB=cm`` within 2 LSB on every
    channel (tests/test_rx_channels.py:130-149)."""
    args = BASE + ["-n", "16", "-M", "fm", "-A", "fast", "-c", "us", "-r",
                   "32k", "-e", "1", "-d", PFB_SRC]
    out_t, out_c = tmp_path / "tm", tmp_path / "cm"
    assert rx_channels.main(args + [str(out_t)]) == 0
    monkeypatch.setenv("RX_PFB", "cm")
    assert rx_channels.main(args + [str(out_c)]) == 0
    ft, fc = _files(out_t), _files(out_c)
    assert [p.name for p in ft] == [p.name for p in fc] and len(ft) == 16
    _within(ft, fc, lsb=2)


@pytest.mark.parametrize("sel", [["-n", "16"], ["-k", "100.2M,100.35M",
                                                "-D", "16"]], ids=["pfb", "mixer"])
def test_chunked_dispatch_identical_to_per_block(sel, tmp_path, monkeypatch):
    """``RX_CHANNELS_CHUNK=1`` (one block a dispatch) gives the default
    chunked dispatch's bytes (tests/test_rx_channels.py:152-169)."""
    args = BASE + sel + ["-M", "fm", "-A", "fast", "-c", "us", "-r", "32k",
                         "-e", "1.2", "-b", "65536", "-d", MIX_SRC]
    out_c, out_p = tmp_path / "chunked", tmp_path / "perblk"
    assert rx_channels.main(args + [str(out_c)]) == 0
    monkeypatch.setenv("RX_CHANNELS_CHUNK", "1")
    assert rx_channels.main(args + [str(out_p)]) == 0
    fc, fp = _files(out_c), _files(out_p)
    assert [p.name for p in fc] == [p.name for p in fp] and fc
    for a, b in zip(fc, fp):
        assert a.read_bytes() == b.read_bytes(), a.name


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "0"},
    {"TPU_WORKER_HOSTNAMES": "a,b"},
], ids=["coordinator", "pod"])
def test_multi_process_env_exits_1(env, monkeypatch, capsys, tmp_path):
    """A configured job that cannot be set up (no peer within the bounded
    set-up timeout, or a pod list with no coordinator) exits 1 and writes
    no channel file."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("RX_DIST_TIMEOUT", "2")
    out = tmp_path / "o"
    t0 = time.monotonic()
    assert rx_channels.main(BASE + ["-n", "16", "-d", PFB_SRC, str(out)]) == 1
    assert time.monotonic() - t0 < 60
    err = capsys.readouterr().err
    assert ("could not join" in err if "JAX_COORDINATOR_ADDRESS" in env
            else "without a coordinator address" in err), err[-500:]
    assert not out.exists()
