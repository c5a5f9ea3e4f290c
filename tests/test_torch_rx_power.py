"""The port's rx_power CLI against the reference CLI and the ``c_ref``
oracle, checkpoint files across packages, the refusals, and rx_heatmap on
the port's CSV.

CSV comparisons skip the timestamp (columns 0-1, as
tests/test_intfft_cli.py:54-59 does).  ``--int-fft`` rows are identical.
Float rows: columns 2-5 (Hz low, Hz high, Hz step, samples) identical;
every dB value within 0.02 dB of the reference's wherever the reference
lies within 60 dB of its row's peak (further down, a bin holds little
more than the FFTs' rounding); ``-inf`` exactly where the reference has
``-inf``."""

import shutil
import time

import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu.apps import rx_heatmap as ref_heatmap
from rx_tools_tpu.apps import rx_power as ref_rx_power
from rx_tools_tpu_torch.apps import rx_heatmap, rx_power
from rx_tools_tpu_torch.iq.sources import make_source
from rx_tools_tpu_torch.models import powerscan
from rx_tools_tpu_torch.models.power_plan import plan_sweep
from rx_tools_tpu_torch.parallel import multihost
from rx_tools_tpu_torch.ops import windows
from rx_tools_tpu_torch.stream import checkpoint
from rx_tools_tpu_torch.utils.units import atofs

torch.set_num_threads(2)

SRC = "synth=tone,det=1,seed=2,carrier=101M|104M,amp=0.4|0.3,noise=0.02"
DB_TOL, DB_RANGE = 0.02, 60.0


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


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


def _both(args, tmp_path, tag=""):
    """The same flags through the reference CLI (one device: ``-t 1``) and
    the port's; returns both CSVs' rows."""
    ref, port = tmp_path / f"ref{tag}.csv", tmp_path / f"port{tag}.csv"
    assert ref_rx_power.main(args + ["-t", "1", str(ref)]) == 0
    assert rx_power.main(args + [str(port)]) == 0
    return _rows(port), _rows(ref)


@pytest.mark.parametrize("flags", [
    ["-f", "99M:101M:1k", "-w", "hamming"],          # BASELINE config #4
    ["-f", "100M:110M:10k", "-c", "20%"],            # config #5, cut
    ["-f", "100M:100.5M:1k", "-F", "9"],             # fifth-order + droop
    ["-f", "100M:100.5M:2k", "-F", "0", "-w", "blackman"],
    ["-f", "100M:106M:20k", "-P", "-w", "youssef"],
    ["-f", "100M:110M:1M"],                          # giant bins
    ["-f", "100M:110M:1M", "-P"],
    ["-f", "100.2M:100.3M:1k", "-w", "bartlett"],    # one hop, boxcar ds
], ids=["config4", "config5", "F9", "F0", "P", "giant", "giant-P",
        "boxcar-ds"])
def test_float_csv_matches_reference_cli(flags, tmp_path):
    got, want = _both(flags + ["-1", "-S", "0", "-d", SRC], tmp_path)
    assert_float_rows(got, want)


def test_exact_zero_bins_are_neg_inf(tmp_path):
    """A silent source: exact zeros after the mean removal, ``-inf`` in
    both CSVs."""
    got, want = _both(["-f", "100M:102M:50k", "-1", "-S", "0", "-d",
                       "synth=silence,noise=0"], tmp_path)
    assert_float_rows(got, want)
    assert all(v == "-inf" for row in got for v in row[4:])


def _oracle_rows(lo, hi, max_bin, crop, window):
    """The CLI's read sequence through the bit-faithful oracle (as
    tests/test_intfft_cli.py builds it): retune, one 4096 flush read, one
    buf_len/2 read a hop, ``scanner_segment`` + ``csv_dbm``."""
    tunes = plan_sweep(lo, hi, max_bin, crop, boxcar=True)
    src = make_source(SRC)
    src.set_sample_rate(tunes[0].rate)
    wc = windows.window_coefs_int(window, 1 << tunes[0].bin_e).tolist()
    rows = []
    for t in tunes:
        src.set_frequency(t.freq)
        src.read_stream(4096)
        n, buf = src.read_stream(t.buf_len // 2)
        avg, samples = c_ref.scanner_segment(list(buf[: 2 * n]), t.bin_e, wc,
                                             ds=t.downsample)
        f_lo, f_hi, step, s, dbms = c_ref.csv_dbm(
            avg, t.bin_e, t.rate, samples, t.crop, t.freq, t.downsample)
        rows.append([str(int(f_lo)), str(int(f_hi)), "%.2f" % step, str(s)]
                    + ["%.2f" % d for d in dbms])
    return rows


@pytest.mark.parametrize("flags,oracle", [
    (["-f", "100M:106M:20k"], ("100M", "106M", "20k", 0.0, "rectangle")),
    (["-f", "100M:104M:50k", "-c", "20%", "-w", "hamming"],
     ("100M", "104M", "50k", 0.2, "hamming")),
], ids=["rect", "crop-hamming"])
def test_int_fft_csv_identical_to_reference_and_oracle(flags, oracle,
                                                       tmp_path):
    """tests/test_intfft_cli.py:62-82's cases: every formatted digit."""
    got, want = _both(flags + ["-1", "-S", "0", "--int-fft", "-d", SRC],
                      tmp_path)
    assert got == want
    lo, hi, b, crop, window = oracle
    assert got == _oracle_rows(atofs(lo), atofs(hi), atofs(b), crop, window)


@pytest.mark.parametrize("flags", [["-P"], ["-f", "100M:110M:1M"]],
                         ids=["P", "giant"])
def test_int_fft_paths_identical_to_reference(flags, tmp_path):
    args = ["-f", "100M:106M:20k"] + flags + ["-1", "-S", "0", "--int-fft",
                                               "-d", SRC]
    got, want = _both(args, tmp_path)
    assert got == want


def test_sweep_summary_and_t_flag(tmp_path, capsys):
    """``-t N`` resolves to the one device: the same CSV and the reference's
    work line."""
    args = ["-f", "100M:106M:20k", "-1", "-S", "0", "-d", SRC]
    assert rx_power.main(args + ["-t", "4", str(tmp_path / "a.csv")]) == 0
    err_port = capsys.readouterr().err
    assert ref_rx_power.main(args + ["-t", "1", str(tmp_path / "b.csv")]) == 0
    err_ref = capsys.readouterr().err

    def summary(err):
        return [ln for ln in err.splitlines() if "Sweep summary:" in ln]

    assert summary(err_port) == summary(err_ref) == [
        "Sweep summary: 1 passes, 3 hop reads (3 hops owned of 3)."]
    assert _rows(tmp_path / "a.csv") == _rows(tmp_path / "b.csv")


def test_exit_timer_flushes_every_sweep_to_stdout(capfdbinary):
    """``-i 0`` flushes after every sweep and ``-e`` stops the run: CSV
    rows on stdout, one a hop for each sweep, each with one sweep's
    samples; the logs stay on stderr."""
    args = ["-f", "100M:103M:50k", "-S", "0", "-i", "0.001", "-e", "0.001",
            "-d", SRC, "-"]
    assert rx_power.main(args) == 0
    cap = capfdbinary.readouterr()
    out = cap.out.decode().strip().splitlines()
    assert len(out) >= 2 and len(out) % 2 == 0
    assert {r.split(", ")[5] for r in out} == {"256"}    # 32-bin hops
    assert b"Sweep summary:" in cap.err


def test_read_sweep_retunes_and_aborts():
    """One sweep's reads: a retune (settle + one flush read) for each hop
    whose frequency differs, one buf_len/2 read a hop; a second SIGINT
    aborts before the next hop, a source that ends aborts and asks the
    loop to stop (the two-stage SIGINT's first stage)."""
    tunes = plan_sweep(100e6, 106e6, 20e3)
    src = make_source(SRC)
    src.set_sample_rate(tunes[0].rate)
    blocks = np.full((len(tunes), tunes[0].buf_len), 7, np.int16)
    bail = [0]
    assert rx_power.read_sweep(src, tunes, blocks, bail, 0, 3) == (False, 3)
    assert bail == [0] and src.get_frequency() == tunes[-1].freq
    want = make_source(SRC)
    want.set_sample_rate(tunes[0].rate)
    want.set_frequency(tunes[1].freq)
    want.read_stream(4096)
    np.testing.assert_array_equal(blocks[1], want.read_stream(
        tunes[1].buf_len // 2)[1])
    assert rx_power.read_sweep(src, tunes, blocks, [2], 0, 3) == (True, 0)

    class Ends:
        def get_frequency(self):
            return tunes[0].freq

        def read_stream(self, n):
            return 0, np.empty(0, np.int16)

    bail = [0]
    assert rx_power.read_sweep(Ends(), tunes, blocks, bail, 0, 3) == (True, 0)
    assert bail == [1]


# ---------------------------------------------------------------------------
# refusals


def test_no_range_is_usage():
    with pytest.raises(SystemExit):
        rx_power.main([])


def test_malformed_range_exits_1(tmp_path):
    assert rx_power.main(["-f", "100M:101M", str(tmp_path / "x.csv")]) == 1


def test_int_fft_refuses_fir_path(tmp_path):
    args = ["-f", "100M:106M:20k", "-1", "-F", "9", "--int-fft", "-d", SRC]
    assert rx_power.main(args + [str(tmp_path / "p.csv")]) == 1
    assert ref_rx_power.main(args + [str(tmp_path / "r.csv")]) == 1


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "0"},
    {"TPU_WORKER_HOSTNAMES": "a,b"},
], ids=["coordinator", "pod"])
def test_multi_process_env_exits_1(env, monkeypatch, capsys, tmp_path):
    """A job the environment configures but that cannot be set up exits 1
    within the bounded set-up timeout and writes nothing: a coordinator
    whose peer never comes, a pod list with no coordinator.  It never
    carries on as one process."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("RX_DIST_TIMEOUT", "2")
    t0 = time.monotonic()
    rc = rx_power.main(["-f", "100M:106M:20k", "-1", "-d", SRC,
                        str(tmp_path / "x.csv")])
    assert rc == 1
    assert time.monotonic() - t0 < 60
    err = capsys.readouterr().err
    assert ("could not join" in err if "JAX_COORDINATOR_ADDRESS" in env
            else "without a coordinator address" in err), err[-500:]
    assert not (tmp_path / "x.csv").exists()


def test_single_process_env_runs(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    assert not multihost.multi_process_env()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert not multihost.multi_process_env()
    assert multihost.init() == 0 and multihost.process_count() == 1
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    assert multihost.multi_process_env()


# ---------------------------------------------------------------------------
# checkpoint/resume, within the port and across packages

CK_ARGS = ["-f", "100M:104M:50k", "-S", "0", "-d", SRC]


def _interrupted(app, tier, ck, tmp_path):
    """One sweep integrated and snapshotted, no flush: ``-e`` stops before
    the hour-long interval ends."""
    args = CK_ARGS + tier + ["-i", "1h", "-e", "0.001", "--checkpoint",
                             str(ck)]
    if app is ref_rx_power:
        args += ["-t", "1"]
    assert app.main(args + [str(tmp_path / "none.csv")]) == 0
    assert (tmp_path / "none.csv").read_text() == ""


def _resumed(app, tier, ck, out):
    args = CK_ARGS + tier + ["-1", "--resume", str(ck)]
    if app is ref_rx_power:
        args += ["-t", "1"]
    assert app.main(args + [str(out)]) == 0
    return _rows(out)


@pytest.mark.parametrize("tier", [[], ["--int-fft"]], ids=["float", "int"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(writer, tier, tmp_path):
    """One package snapshots a sweep, the other resumes it: the resumed
    CSV has the writer's own resume's columns 2-5 (two sweeps' samples)
    and its dB values (identical for --int-fft)."""
    first, second = ((ref_rx_power, rx_power) if writer == "reference"
                     else (rx_power, ref_rx_power))
    ck = tmp_path / "ck.npz"
    _interrupted(first, tier, ck, tmp_path)
    meta = checkpoint.read_meta(str(ck))
    assert meta == {"h_pad": 2, "bin_e": 6, "buf_len": 16384, "n_tunes": 2,
                    "n_proc": 1, "pid": 0, "int_fft": bool(tier)}
    shutil.copy(ck, tmp_path / "ck2.npz")
    own = _resumed(first, tier, ck, tmp_path / "own.csv")
    other = _resumed(second, tier, tmp_path / "ck2.npz",
                     tmp_path / "other.csv")
    once = _resumed(first, tier, tmp_path / "fresh.npz",
                    tmp_path / "once.csv")
    assert [r[3] for r in own] == [str(2 * int(r[3])) for r in once]
    if tier:
        assert other == own
    else:
        assert_float_rows(other, own)


def test_int_checkpoint_leaves_are_host_int64(tmp_path):
    """The int tier's accumulators round-trip as numpy int64 in the
    reference's leaf order; a float-tier file's leaves load to the card's
    template dtypes."""
    ck = tmp_path / "ck.npz"
    _interrupted(rx_power, ["--int-fft"], ck, tmp_path)
    tmpl = powerscan.SweepAccum(np.zeros((2, 64), np.int64),
                                np.zeros(2, np.int64))
    acc, meta = checkpoint.load_checkpoint(str(ck), tmpl)
    assert isinstance(acc.avg, np.ndarray) and acc.avg.dtype == np.int64
    assert (acc.samples == 128).all() and acc.avg.min() > 0
    assert meta["int_fft"] is True
    ck2 = tmp_path / "f.npz"
    _interrupted(rx_power, [], ck2, tmp_path)
    cfg = powerscan.PowerConfig(bin_e=6)
    acc, _ = checkpoint.load_checkpoint(
        str(ck2), powerscan.new_sweep_accum(2, cfg, "cpu"))
    assert acc.avg.dtype == torch.float32 and acc.samples.dtype == torch.int32
    assert (acc.samples == 128).all()


@pytest.mark.parametrize("written,resumed", [([], ["--int-fft"]),
                                             (["--int-fft"], [])],
                         ids=["float-file-int-run", "int-file-float-run"])
def test_resume_refuses_other_tier(written, resumed, tmp_path):
    ck = tmp_path / "ck.npz"
    _interrupted(rx_power, written, ck, tmp_path)
    assert rx_power.main(CK_ARGS + resumed + ["-1", "--resume", str(ck),
                                              str(tmp_path / "x.csv")]) == 1


def test_resume_refuses_other_plan(tmp_path):
    ck = tmp_path / "ck.npz"
    _interrupted(rx_power, [], ck, tmp_path)
    args = ["-f", "100M:104M:20k", "-S", "0", "-1", "-d", SRC, "--resume",
            str(ck), str(tmp_path / "x.csv")]
    assert rx_power.main(args) == 1


def test_resume_without_file_starts_fresh(tmp_path):
    ck = tmp_path / "missing.npz"
    rows = _resumed(rx_power, [], ck, tmp_path / "a.csv")
    assert rows and ck.exists()


# ---------------------------------------------------------------------------
# rx_heatmap


def test_heatmap_on_port_csv(tmp_path):
    """tests/test_heatmap.py's e2e on the port: the tone is the hottest
    column, and the PNG is the reference's byte for byte."""
    csv = tmp_path / "sweep.csv"
    assert rx_power.main(["-f", "100M:101M:25k", "-1", "-d",
                          "synth=tone,carrier=100.4M,amp=0.5",
                          str(csv)]) == 0
    png, ref_png = tmp_path / "sweep.png", tmp_path / "ref.png"
    assert rx_heatmap.main([str(csv), str(png)]) == 0
    assert ref_heatmap.main([str(csv), str(ref_png)]) == 0
    assert png.read_bytes() == ref_png.read_bytes()
    times, f_lo, step, data = rx_heatmap.parse_csv(open(csv))
    col = int(np.argmax(np.nan_to_num(data[0], nan=-1e9)))
    assert abs((f_lo + col * step) - 100.4e6) <= 2 * step


def test_heatmap_parse_and_width_match_reference(tmp_path):
    lines = [
        "2026-08-18, 10:00:00, 100000000, 100000400, 100.0, 32, 1, 2, 3, 4",
        "2026-08-18, 10:00:00, 100000400, 100000800, 100.0, 32, 5, 6, 7, 8",
        "2026-08-18, 10:00:10, 100000000, 100000400, 100.0, 32, 9, 9, 9, 9",
    ]
    got, want = rx_heatmap.parse_csv(lines), ref_heatmap.parse_csv(lines)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    norm = np.linspace(-0.2, 1.2, 64).reshape(4, 16)
    norm[0, 0] = np.nan
    np.testing.assert_array_equal(rx_heatmap.colorize(norm),
                                  ref_heatmap.colorize(norm))
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(lines) + "\n")
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    assert rx_heatmap.main(["--width", "3", "--db", "0:10", str(csv),
                            str(a)]) == 0
    assert ref_heatmap.main(["--width", "3", "--db", "0:10", str(csv),
                             str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(SystemExit):
        rx_heatmap.main([str(csv)])
