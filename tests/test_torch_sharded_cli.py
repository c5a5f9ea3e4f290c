"""The port's sharded CLIs on eight CPU devices (``JAX_NUM_CPU_DEVICES=8``,
the count tests/conftest.py gives the reference package), case for case
with tests/test_sharded_cli.py: rx_power's hop shards (``-t``) and rx_fm's
``-E shard`` against their single-device runs and the reference CLI, and a
checkpoint that crosses packages at the default ``-t`` (both sides pad the
hop rows to the same mesh)."""

import shutil

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.apps import rx_power as ref_rx_power
from rx_tools_tpu_torch.apps import rx_fm, rx_power, rx_sdr
from rx_tools_tpu_torch.stream import checkpoint
from util import snr_db

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    monkeypatch.setenv("JAX_NUM_CPU_DEVICES", "8")


def _strip_stamps(csv_text):
    return ["".join(l.split(", ")[2:]) for l in csv_text.splitlines()]


def test_rx_power_hop_sharded_matches_single_device(tmp_path, capsys):
    """-t 8 (hops over 8 devices) CSV == -t 1 CSV, stamps aside
    (tests/test_sharded_cli.py:25-35)."""
    args = ["-f", "100M:120M:100k", "-1", "-c", "20%", "-S", "0",
            "-d", "synth=tone,carrier=111.4M,amp=0.5,noise=0.01,seed=3"]
    out1, out8 = tmp_path / "t1.csv", tmp_path / "t8.csv"
    assert rx_power.main(args + ["-t", "1", str(out1)]) == 0
    assert rx_power.main(args + ["-t", "8", str(out8)]) == 0
    assert "Sharding 9 hops over 8 devices (16 rows" in capsys.readouterr().err
    rows1 = _strip_stamps(out1.read_text())
    assert len(rows1) > 4
    assert rows1 == _strip_stamps(out8.read_text())


@pytest.mark.parametrize("tier", [[], ["--int-fft"]], ids=["float", "int"])
def test_rx_power_sharded_padding_rows_never_flushed(tier, tmp_path):
    """3 hops over -t 2 pad to 4 rows; only the real hops reach the CSV,
    which is the -t 1 CSV (stamps aside), and the float tier's stitched
    peak lands on the tone (tests/test_sharded_cli.py:38-56)."""
    args = ["-f", "100M:106M:10k", "-1", "-S", "0",
            "-d", "synth=tone,carrier=102.5M,amp=0.5,seed=4"] + tier
    out, one = tmp_path / "odd.csv", tmp_path / "one.csv"
    assert rx_power.main(args + ["-t", "2", str(out)]) == 0
    assert rx_power.main(args + ["-t", "1", str(one)]) == 0
    rows = out.read_text().splitlines()
    assert len(rows) == 3
    assert _strip_stamps(out.read_text()) == _strip_stamps(one.read_text())
    if tier:
        return
    best = (-1e9, None)
    for r in rows:
        cols = r.split(", ")
        dbms = np.array([float(x) for x in cols[6:-1]])
        i = int(np.argmax(dbms))
        if dbms[i] > best[0]:
            best = (dbms[i], float(cols[2]) + i * float(cols[4]))
    assert abs(best[1] - 102.5e6) < 5e4


CK_ARGS = ["-f", "100M:126M:50k", "-S", "0",
           "-d", "synth=tone,det=1,seed=2,carrier=101M|114M,amp=0.4|0.3,"
                 "noise=0.02"]


@pytest.mark.parametrize("tier", [[], ["--int-fft"]], ids=["float", "int"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages_default_t(writer, tier, tmp_path):
    """At the default -t both packages see 8 devices and pad the 10 hops to
    16 rows: the checkpoint meta is the same, and one package resumes the
    other's snapshot (the writer's own resume's columns 2-5, dB within
    float tolerance; identical for --int-fft)."""
    first, second = ((ref_rx_power, rx_power) if writer == "reference"
                     else (rx_power, ref_rx_power))
    ck = tmp_path / "ck.npz"
    assert first.main(CK_ARGS + tier + ["-i", "1h", "-e", "0.001",
                                        "--checkpoint", str(ck),
                                        str(tmp_path / "none.csv")]) == 0
    meta = checkpoint.read_meta(str(ck))
    assert meta == {"h_pad": 16, "bin_e": 6, "buf_len": 16384,
                    "n_tunes": 10, "n_proc": 1, "pid": 0,
                    "int_fft": bool(tier)}
    shutil.copy(ck, tmp_path / "ck2.npz")
    own, other = tmp_path / "own.csv", tmp_path / "other.csv"
    assert first.main(CK_ARGS + tier + ["-1", "--resume", str(ck),
                                        str(own)]) == 0
    assert second.main(CK_ARGS + tier + ["-1", "--resume",
                                         str(tmp_path / "ck2.npz"),
                                         str(other)]) == 0
    own_rows = [l.split(", ")[2:] for l in own.read_text().splitlines()]
    other_rows = [l.split(", ")[2:] for l in other.read_text().splitlines()]
    assert len(own_rows) == len(other_rows) == 10
    for g, w in zip(other_rows, own_rows):
        assert g[:4] == w[:4]
        if tier:
            assert g == w
        else:
            gd, wd = np.array(g[4:], float), np.array(w[4:], float)
            ok = np.isfinite(wd) & (wd > wd.max() - 60)
            assert np.abs(gd[ok] - wd[ok]).max() <= 0.02


def _record(tmp_path, name, rate, n, carrier, f, dev="15k"):
    cap = tmp_path / name
    assert rx_sdr.main(["-d", f"synth=fm,carrier={carrier},audio=1k,"
                        f"dev={dev},amp=0.8,noise=0.001", "-f", f,
                        "-s", str(rate), "-n", str(n), "-F", "CS16",
                        str(cap)]) == 0
    return cap


def test_rx_fm_shard_exact_for_fir_only_chain(tmp_path, monkeypatch, capsys):
    """-E shard == the streaming run, byte for byte, on a chain with no IIR
    stage (-M fm): RX_SHARD_BLOCKS=5 streams the capture as two sharded
    super-chunks (first and continuation) plus a one-device tail
    (tests/test_sharded_cli.py:69-90)."""
    cap = _record(tmp_path, "c.cs16", 1_056_000, 1_584_000,
                  carrier="100M", f="100.264M")
    base = ["-f", "100M", "-M", "fm", "-s", "96k", "-A", "std",
            "-d", f"file={cap},format=CS16,rate=1056k"]
    a_stream, a_shard = tmp_path / "stream.raw", tmp_path / "shard.raw"
    assert rx_fm.main(base + [str(a_stream)]) == 0
    monkeypatch.setenv("RX_SHARD_BLOCKS", "5")
    assert rx_fm.main(base + ["-E", "shard", str(a_shard)]) == 0
    assert "Sharding super-chunks of 40 blocks over 8 devices" in \
        capsys.readouterr().err
    s = np.fromfile(a_stream, np.int16)
    assert s.size > 50000
    np.testing.assert_array_equal(s, np.fromfile(a_shard, np.int16))


def _wbfm_pair(tmp_path, monkeypatch, extra, carrier, f):
    cap = _record(tmp_path, "w.cs16", 1_020_000, 1_530_000, carrier=carrier,
                  f=f, dev="75k")
    base = ["-f", "100M", "-M", "wbfm", "-A", "std", *extra,
            "-d", f"file={cap},format=CS16,rate=1020k"]
    a_stream, a_shard = tmp_path / "s.raw", tmp_path / "h.raw"
    assert rx_fm.main(base + [str(a_stream)]) == 0
    monkeypatch.setenv("RX_SHARD_BLOCKS", "4")   # force super-chunking
    assert rx_fm.main(base + ["-E", "shard", str(a_shard)]) == 0
    s = np.fromfile(a_stream, np.int16).astype(np.float64)
    h = np.fromfile(a_shard, np.int16).astype(np.float64)
    assert s.size == h.size > 20000
    k = s.size // 20            # the turn-on transient both runs share
    assert snr_db(s[k:], h[k:]) > 35
    return base, h


def test_rx_fm_shard_wbfm_snr(tmp_path, monkeypatch):
    """wbfm via -E shard: the tone back, SNR > 35 dB against streaming
    (tests/test_sharded_cli.py:93-114); and within 1 LSB of the reference
    CLI's -E shard on its 8 devices, with the same sample count."""
    base, h = _wbfm_pair(tmp_path, monkeypatch, [], "100.016M", "100.271M")
    a = h[2000:] - h[2000:].mean()
    sp = np.abs(np.fft.rfft(a * np.hanning(a.size))) ** 2
    fr = np.fft.rfftfreq(a.size, 1 / 32000)
    assert abs(fr[np.argmax(sp)] - 1000.0) < 10
    ref = tmp_path / "ref.raw"
    assert ref_rx_fm.main(base + ["-E", "shard", str(ref)]) == 0
    want = np.fromfile(ref, np.int16).astype(np.float64)
    assert want.size == h.size
    assert np.abs(want - h).max() <= 1


def test_rx_fm_shard_wbfm_dc_snr(tmp_path, monkeypatch):
    """wbfm + -E dc via -E shard: the audio DC block rides the exact seam,
    SNR > 35 dB against streaming with the carrier off the tuned frequency
    (tests/test_sharded_cli.py:117-135)."""
    _wbfm_pair(tmp_path, monkeypatch, ["-E", "dc"], "100.020M", "100.275M")


def test_rx_fm_shard_tail_path(tmp_path):
    """A capture shorter than one super-chunk takes the one-device tail
    replay, still the streaming bytes (tests/test_sharded_cli.py:138-150)."""
    cap = _record(tmp_path, "t.cs16", 1_056_000, 700_000,
                  carrier="100M", f="100.264M")
    base = ["-f", "100M", "-M", "fm", "-s", "96k", "-A", "std",
            "-d", f"file={cap},format=CS16,rate=1056k"]
    a_stream, a_shard = tmp_path / "st.raw", tmp_path / "sh.raw"
    assert rx_fm.main(base + [str(a_stream)]) == 0
    assert rx_fm.main(base + ["-E", "shard", str(a_shard)]) == 0
    np.testing.assert_array_equal(np.fromfile(a_stream, np.int16),
                                  np.fromfile(a_shard, np.int16))


def test_rx_fm_shard_rejects_scan_and_squelch(tmp_path):
    assert rx_fm.main(["-f", "100M", "-l", "50", "-E", "shard",
                       "-d", "synth=tone", str(tmp_path / "o.raw")]) == 1
