"""Checkpoint/resume and the -b 1 StreamRunner in the port, and checkpoint
files across packages (tests/test_checkpoint_cli.py's scenarios): a
snapshot written by either package resumes in the other, and an
interrupted run resumed gives the bytes of an uninterrupted one."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.models import fmchain as ref_chain
from rx_tools_tpu.stream import checkpoint as ref_ckpt
from rx_tools_tpu.stream import scan as ref_scan
from rx_tools_tpu_torch.apps import rx_fm
from rx_tools_tpu_torch.iq.sources import make_source
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.stream import checkpoint, scan
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner
from rx_tools_tpu_torch.stream.pipeline import StreamRunner

torch.set_num_threads(2)

BLOCK = 8232          # -s 24k: ceil(8192 / 168) * 168 complex samples


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    monkeypatch.setenv("RX_PLATFORM", "cpu")


def _capture(tmp_path, n_blocks):
    """A deterministic FM capture at the fm-mode plan (-s 24k -> D = 42 ->
    1008k, the station at -fs/4 of the file centre)."""
    src = make_source("synth=fm,audio=1k,dev=9k,amp=0.8,noise=0.001,"
                      "carrier=100M,seed=7")
    src.set_sample_rate(1_008_000)
    src.set_frequency(100.252e6)
    cap = tmp_path / "cap.cs16"
    src.read_stream(n_blocks * BLOCK)[1].tofile(cap)
    return cap


def _args(cap, extra, out):
    return (["-f", "100M", "-s", "24k",
             "-d", f"file={cap},format=CS16,rate=1008k"]
            + extra + [str(out)])


def test_cli_interrupt_resume_bit_identical(tmp_path):
    """An interrupted run (--blocks) resumed to EOF gives the bytes of an
    uninterrupted run, the WAV header and a torn tail included."""
    cap = _capture(tmp_path, 48)
    ref, out, ck = tmp_path / "ref.wav", tmp_path / "out.wav", \
        tmp_path / "st.npz"
    assert rx_fm.main(_args(cap, ["-E", "wav"], ref)) == 0
    assert rx_fm.main(_args(cap, ["-E", "wav", "--checkpoint", str(ck),
                                  "--blocks", "20"], out)) == 0
    assert ck.exists() and out.read_bytes() != ref.read_bytes()
    with open(out, "ab") as f:          # a crash wrote past the snapshot
        f.write(b"\xde\xad\xbe")
    assert rx_fm.main(_args(cap, ["-E", "wav", "--resume", str(ck)],
                            out)) == 0
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cli_resume_across_packages(writer, tmp_path):
    """One package checkpoints an interrupted run, the other resumes it.
    The file up to the snapshot is the writer's uninterrupted output byte
    for byte (the rewind and the source skip land exactly), and the whole
    file has the uninterrupted sample count, within 1 LSB of either
    package's uninterrupted run: the float chains of the two packages
    differ by rounding on the CPU (the reference's head is a float32
    matrix product), the float tier's bar."""
    cap = _capture(tmp_path, 40)
    full = {}
    for name, app in (("reference", ref_rx_fm), ("port", rx_fm)):
        full[name] = tmp_path / f"{name}.wav"
        assert app.main(_args(cap, ["-E", "wav"], full[name])) == 0
    first, second = ((ref_rx_fm, rx_fm) if writer == "reference"
                     else (rx_fm, ref_rx_fm))
    out, ck = tmp_path / "out.wav", tmp_path / "st.npz"
    assert first.main(_args(cap, ["-E", "wav", "--checkpoint", str(ck),
                                  "--blocks", "20"], out)) == 0
    n_out = checkpoint.read_meta(str(ck))["samples_out"]
    assert second.main(_args(cap, ["-E", "wav", "--resume", str(ck)],
                             out)) == 0
    got = out.read_bytes()
    head = 44 + 2 * n_out
    assert 0 < n_out and got[:head] == full[writer].read_bytes()[:head]
    pcm = np.frombuffer(got[44:], np.int16).astype(int)
    for name in full:
        want = np.frombuffer(full[name].read_bytes()[44:], np.int16)
        assert pcm.size == want.size
        assert np.abs(pcm - want).max() <= 1


def _wbfm():
    return fmchain.plan_capture(fmchain.wbfm_preset(), 100.3e6)[0]


def test_state_files_load_across_packages(tmp_path):
    """Leaf for leaf, dtype and shape: a reference-package snapshot loads
    into the port's template and the port's into the reference's; the
    port's own round trip is lossless."""
    cfg = dataclasses.replace(_wbfm(), fir_quality=24, resample_quality=16,
                              downsample_passes=0)
    rcfg = ref_chain.FmConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    blocks = rng.integers(-8000, 8000, (3, 2 * fmchain.block_samples(
        cfg, target=480))).astype(np.int16)
    rst, _, _, _ = ref_scan.scan_fm_blocks(rcfg, ref_chain.init_state(rcfg),
                                           jax.numpy.asarray(blocks))
    st, _, _, _ = scan.scan_fm_blocks(cfg, fmchain.init_state(cfg, "cpu"),
                                      blocks)
    ref_path, port_path = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    ref_ckpt.save_checkpoint(ref_path, jax.device_get(rst), meta={"k": 1})
    checkpoint.save_checkpoint(port_path, st, meta={"k": 2})
    got, meta = checkpoint.load_checkpoint(ref_path,
                                           fmchain.init_state(cfg, "cpu"))
    assert meta == {"k": 1} and checkpoint.read_meta(port_path) == {"k": 2}
    for a, b in zip(checkpoint.tree_leaves(got),
                    jax.tree.leaves(jax.device_get(rst))):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, _ = ref_ckpt.load_checkpoint(port_path, ref_chain.init_state(rcfg))
    for a, b in zip(jax.tree.leaves(back), checkpoint.tree_leaves(st)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    again, _ = checkpoint.load_checkpoint(port_path,
                                          fmchain.init_state(cfg, "cpu"))
    assert type(again) is fmchain.FmState
    for a, b in zip(checkpoint.tree_leaves(again),
                    checkpoint.tree_leaves(st)):
        assert torch.equal(a, b)


def test_load_refuses_another_chain(tmp_path):
    cfg = _wbfm()
    path = str(tmp_path / "s.npz")
    checkpoint.save_checkpoint(path, fmchain.init_state(cfg, "cpu"))
    other = dataclasses.replace(cfg, fir_quality=24)
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(path, fmchain.init_state(other, "cpu"))


def test_b1_streamrunner_matches_chunked(tmp_path):
    cap = _capture(tmp_path, 24)
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    assert rx_fm.main(_args(cap, [], a)) == 0
    assert rx_fm.main(_args(cap, ["-b", "1"], b)) == 0
    assert len(a.read_bytes()) > 8000
    assert a.read_bytes() == b.read_bytes()


def test_b1_checkpoint_every_block_and_resume(tmp_path):
    """-b 1 snapshots after every drained block; a resumed -b 1 run gives
    the bytes of an uninterrupted chunked run."""
    cap = _capture(tmp_path, 24)
    ref, out, ck = tmp_path / "r.raw", tmp_path / "o.raw", tmp_path / "s.npz"
    assert rx_fm.main(_args(cap, [], ref)) == 0
    assert rx_fm.main(_args(cap, ["-b", "1", "--checkpoint", str(ck),
                                  "--blocks", "7"], out)) == 0
    assert checkpoint.read_meta(str(ck))["blocks"] == 7
    assert rx_fm.main(_args(cap, ["-b", "1", "--resume", str(ck)], out)) == 0
    assert out.read_bytes() == ref.read_bytes()


def test_streamrunner_drains_like_chunked_runner():
    """Runner level: the per-block runner's sink sees the chunked runner's
    blocks, value for value (scan engine bitwise == stepping on the CPU)."""
    cfg = _wbfm()
    n = fmchain.block_samples(cfg, target=2016)

    def src():
        s = make_source("synth=fm,det=1,seed=3,audio=1k,dev=50k,amp=0.6")
        s.set_sample_rate(170000 * 6)
        s.set_frequency(100e6)
        return s

    a, b = [], []
    ChunkedFmRunner(cfg, src(), lambda x, lvl: a.append(x.copy()), chunk=4,
                    block_size=n, device="cpu").run(max_blocks=9)
    r = StreamRunner(lambda st, blk: fmchain.fm_chain_step(cfg, st, blk),
                     fmchain.init_state(cfg, "cpu"), src(), n,
                     lambda x, lvl: b.append(x.copy()))
    stats = r.run(max_blocks=9)
    assert stats.blocks == 9 and len(a) == len(b) == 9
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_resume_rejects_changed_plan(tmp_path):
    cap = _capture(tmp_path, 20)
    ck, out = tmp_path / "s.npz", tmp_path / "o.raw"
    assert rx_fm.main(_args(cap, ["--checkpoint", str(ck), "--blocks", "16"],
                            out)) == 0
    # -s 32k plans D = 32 and 8192-sample blocks: refused, not corrupted
    assert rx_fm.main(["-f", "100M", "-s", "32k",
                       "-d", f"file={cap},format=CS16,rate=1008k",
                       "--resume", str(ck), str(out)]) == 1


def test_checkpoint_rejected_while_scanning(tmp_path):
    assert rx_fm.main(["-f", "100M", "-f", "101M", "-l", "10",
                       "--checkpoint", str(tmp_path / "ck.npz"),
                       "-d", "synth=fm", str(tmp_path / "o.raw")]) == 1


@pytest.mark.parametrize("runner_flags", [[], ["-b", "1"]],
                         ids=["chunked", "b1"])
def test_synth_resume_repeats_one_pass(runner_flags, tmp_path):
    """The resume skip reads the source in the runner's block size, so the
    synth (whose noise draws depend on read sizes) gives after the skip
    the samples of one pass: resumed == uninterrupted, byte for byte."""
    src = ["-f", "100M", "-s", "24k", "-d",
           "synth=fm,audio=1k,dev=9k,amp=0.8,noise=0.01,carrier=100M,seed=7"]
    ref, out, ck = tmp_path / "r.raw", tmp_path / "o.raw", tmp_path / "s.npz"
    assert rx_fm.main(src + runner_flags + ["--blocks", "24", str(ref)]) == 0
    assert rx_fm.main(src + runner_flags + ["--checkpoint", str(ck),
                                            "--blocks", "9", str(out)]) == 0
    assert rx_fm.main(src + runner_flags + ["--resume", str(ck),
                                            "--blocks", "24", str(out)]) == 0
    assert out.read_bytes() == ref.read_bytes()
