"""The port's multi-process jobs: local gloo processes on 127.0.0.1, set up
from the reference package's variables (``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), case for case with
tests/test_multihost*.py: the collectives themselves, rx_power's divided
sweep in both tiers, rx_channels' divided channels and stations, and rx_fm
``-E shard`` across two processes.  Every child has its own timeout, and
all of a run's children are killed when one runs out."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rx_tools_tpu.apps import rx_sdr as ref_rx_sdr
from rx_tools_tpu_torch.stream import checkpoint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a port CLI in a child: rx_tools_tpu_torch.apps.<argv[1]>.main(argv[2:])
_PORT = textwrap.dedent("""
    import importlib, sys
    import torch
    torch.set_num_threads(1)
    app = importlib.import_module("rx_tools_tpu_torch.apps." + sys.argv[1])
    sys.exit(app.main(sys.argv[2:]))
""")

# the reference CLI in a child, on argv[1] virtual CPU devices
_REF = textwrap.dedent("""
    import importlib, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", int(sys.argv[1]))
    app = importlib.import_module("rx_tools_tpu.apps." + sys.argv[2])
    sys.exit(app.main(sys.argv[3:]))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(n_proc, pid, coord, extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["RX_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jaxcache")
    for k in ("JAX_PLATFORMS", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "TPU_WORKER_HOSTNAMES", "JAX_NUM_CPU_DEVICES",
              "RX_SHARD_BLOCKS", "RX_PFB"):
        env.pop(k, None)
    if n_proc > 1:
        env["JAX_COORDINATOR_ADDRESS"] = coord
        env["JAX_NUM_PROCESSES"] = str(n_proc)
        env["JAX_PROCESS_ID"] = str(pid)
    env.update(extra or {})
    return env


def _run(argvs, n_proc, tag, extra=None, timeout=180):
    """One job of ``n_proc`` processes, process ``p`` running
    ``argvs(p)``; returns each process's stderr.  A child that outlives its
    timeout gets every child of the job killed."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c"] + argvs(pid), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, env=_env(n_proc, pid, coord, extra))
        for pid in range(n_proc)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"{tag} process {i}:\n{errs[i][-3000:]}"
    return errs


def _port(app, argv, n_proc=1, extra=None, tag="port"):
    return _run(lambda pid: [_PORT, app] + argv(pid), n_proc, tag, extra)


def _ref(app, argv, n_proc=1, devices=1, extra=None, tag="reference"):
    return _run(lambda pid: [_REF, str(devices), app] + argv(pid), n_proc,
                tag, extra, timeout=300)


_PRIMITIVES = textwrap.dedent("""
    import numpy as np
    from rx_tools_tpu_torch.parallel import multihost
    pid = multihost.init()
    n = multihost.process_count()
    assert n == 2 and multihost.process_index() == pid
    assert multihost.is_primary() == (pid == 0)
    g = multihost.allgather(np.arange(3, dtype=np.float32) + pid)
    assert g.dtype == np.float32 and g.tolist() == [[0, 1, 2], [1, 2, 3]]
    big = np.array([2**40 + 7, -(2**40) - 3, 2**31 + 5], np.int64)
    e = multihost.allgather_exact_i64(big * (pid + 1))
    assert e.dtype == np.int64
    assert (e[0] == big).all() and (e[1] == 2 * big).all(), e
    f = multihost.broadcast_flags(np.array([pid + 5, 1 - pid], np.int32))
    assert f.tolist() == [5, 1], f
    mesh = multihost.global_mesh("t")
    assert mesh.ranks == (0, 1) and mesh.local(pid) == [pid]
    print("OK", pid, flush=True)
""")


def test_two_process_collectives():
    """The gloo control plane and its collectives across a real process
    boundary (tests/test_multihost.py): gather, the int64-exact gather at
    +-2**40, the primary's flags and the rank-major mesh."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _PRIMITIVES],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=_env(2, pid, coord, None))
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err.decode()[-3000:]
        assert f"OK {pid}" in out.decode()


def _csv_body(path):
    with open(path) as f:
        return [line.strip().split(", ")[2:] for line in f]


POWER_SRC = ("synth=tone,det=1,noise=0.01,seed=5,"
             "carrier=91M|93.5M|96M,amp=0.5|0.3|0.2")


@pytest.mark.parametrize("tier", [[], ["--int-fft"]], ids=["float", "int"])
def test_two_process_sweep_csv_identical(tier, tmp_path):
    """2-process divided sweep CSV == 1-process CSV exactly, in both tiers
    (the int64 accumulators gathered exactly), and each process's
    checkpoint meta is the reference CLI's for the same job
    (tests/test_multihost_power.py:106-120, 173-188)."""
    argv = ["-f", "90M:98M:125k", "-1", "-t", "1", "-S", "0", "-d",
            POWER_SRC] + tier
    csv1, csv2 = tmp_path / "single.csv", tmp_path / "multi.csv"
    _port("rx_power", lambda pid: argv + [str(csv1)])
    errs = _port("rx_power", lambda pid: argv + [
        "--checkpoint", str(tmp_path / f"ck{pid}.npz"), str(csv2)], 2)
    assert "Multi-process sweep: process 0/2 owns hops 0..1 of 3" in errs[0]
    assert "Multi-process sweep: process 1/2 owns hops 2..2 of 3" in errs[1]
    body1, body2 = _csv_body(csv1), _csv_body(csv2)
    assert len(body1) == 3 and body1 == body2
    if tier:
        return
    _ref("rx_power", lambda pid: argv + [
        "--checkpoint", str(tmp_path / f"rck{pid}.npz"),
        str(tmp_path / "ref.csv")], 2)
    for pid in range(2):
        meta = checkpoint.read_meta(str(tmp_path / f"ck{pid}.npz"))
        assert meta == checkpoint.read_meta(str(tmp_path / f"rck{pid}.npz"))
        assert (meta["n_proc"], meta["pid"], meta["h_pad"]) == (2, pid, 2)


def _sweep_summary(err):
    import re
    m = re.search(r"Sweep summary: (\d+) passes, (\d+) hop reads "
                  r"\((\d+) hops owned of (\d+)\)", err)
    assert m, err[-2000:]
    return tuple(int(g) for g in m.groups())


def test_two_process_sweep_division_deterministic(tmp_path):
    """The work divides exactly: on a 50-hop sweep each process reads its
    own half, once, and the stitched CSV is the 1-process CSV
    (tests/test_multihost_power.py:136-170)."""
    base = ["-f", "100M:240M:125k", "-1", "-t", "1", "-S", "0", "-d",
            "synth=tone,det=1,seed=1,carrier=150M"]
    err1 = _port("rx_power", lambda pid: base + [str(tmp_path / "d1.csv")])
    errs2 = _port("rx_power", lambda pid: base + [str(tmp_path / "d2.csv")],
                  2)
    p1, r1, own1, tot1 = _sweep_summary(err1[0])
    assert (p1, own1) == (1, tot1) and r1 == tot1 >= 50
    sums = [_sweep_summary(e) for e in errs2]
    assert [s[3] for s in sums] == [tot1, tot1]
    assert sorted(s[2] for s in sums) == sorted(
        [-(-tot1 // 2), tot1 - -(-tot1 // 2)])
    assert all(p == 1 and r == o for p, r, o, _ in sums)
    assert sum(s[1] for s in sums) == tot1
    assert _csv_body(tmp_path / "d1.csv") == _csv_body(tmp_path / "d2.csv")


def _compare_dirs(d1, d2, n_expect, atol_lsb=2):
    f1, f2 = sorted(d1.glob("ch*.s16")), sorted(d2.glob("ch*.s16"))
    assert [p.name for p in f1] == [p.name for p in f2]
    assert len(f1) == n_expect
    for a, b in zip(f1, f2):
        x = np.fromfile(a, np.int16).astype(np.int64)
        y = np.fromfile(b, np.int16).astype(np.int64)
        assert x.size == y.size > 500, a.name
        assert np.abs(x - y).max() <= atol_lsb, a.name


def test_two_process_pfb_channels(tmp_path):
    """2-process -n 16: channels 0..7 and 8..15, each process's DFT rows
    over the replicated filterbank, within 2 LSB of the 1-process
    channel-major run (tests/test_multihost_channels.py:78-94)."""
    args = ["-f", "100M", "-s", "1024k", "-n", "16", "-M", "fm", "-A", "fast",
            "-c", "us", "-r", "32k", "-e", "1",
            "-d", "synth=fm,det=1,seed=9,carrier=100.192M,audio=1k,dev=15k,"
                  "amp=0.8"]
    out1, out2 = tmp_path / "p1", tmp_path / "p2"
    _port("rx_channels", lambda pid: args + [str(out1)],
          extra={"RX_PFB": "cm"})
    errs = _port("rx_channels", lambda pid: args + [str(out2)], 2)
    assert "owns channels 0..7 of 16" in errs[0]
    assert "owns channels 8..15 of 16" in errs[1]
    _compare_dirs(out1, out2, 16)


@pytest.mark.parametrize("n_proc", [2, 5])
def test_multi_process_mixer_channels(n_proc, tmp_path):
    """-k with 4 stations over 2 processes (two each) gives the 1-process
    audio (tests/test_multihost_channels.py:97-111).  Over 5 processes the
    last owns none: it logs so and exits 0 (the reference builds empty
    state there, ADVICE.md:5), and the other four write one file each."""
    args = ["-f", "100M", "-s", "1024k",
            "-k", "100.192M,99.936M,100.017M,100.26M", "-D", "16",
            "-M", "fm", "-A", "fast", "-c", "us", "-r", "32k", "-e", "1",
            "-d", "synth=fm,det=1,seed=7,carrier=100.192M,audio=1k,dev=15k,"
                  "amp=0.8"]
    out1, out2 = tmp_path / "m1", tmp_path / "m2"
    _port("rx_channels", lambda pid: args + [str(out1)])
    errs = _port("rx_channels", lambda pid: args + [str(out2)], n_proc)
    if n_proc == 2:
        assert "owns stations 0..1" in errs[0]
        assert "owns stations 2..3" in errs[1]
    else:
        assert "process 4/5 owns no channels" in errs[4]
        assert "owns stations 3..3" in errs[3]
    _compare_dirs(out1, out2, 4)


def test_two_process_fm_shard(tmp_path):
    """rx_fm -E shard over 2 processes x 2 devices is byte-identical to 1
    process x 4 (the same mesh, rank-major), and within 1 LSB of the
    reference CLI at 1 x 4 with the same count
    (tests/test_multihost_fm.py:83-103)."""
    cap = tmp_path / "cap.cs16"
    assert ref_rx_sdr.main(["-d", "synth=fm,audio=1k,dev=75k,amp=0.8,"
                            "noise=0.001,carrier=100.3M", "-f", "100.555M",
                            "-s", "1020k", "-n", "700k", "-F", "CS16",
                            str(cap)]) == 0
    argv = ["-f", "100.3M", "-M", "wbfm", "-E", "shard",
            "-d", f"file={cap},format=CS16,rate=1020k"]
    one, two, ref = (tmp_path / f for f in ("one.pcm", "two.pcm", "ref.pcm"))
    env = {"RX_SHARD_BLOCKS": "3"}
    err1 = _port("rx_fm", lambda pid: argv + [str(one)],
                 extra=dict(env, JAX_NUM_CPU_DEVICES="4"))
    err2 = _port("rx_fm", lambda pid: argv + [str(two)], 2,
                 extra=dict(env, JAX_NUM_CPU_DEVICES="2"))
    assert "Sharding super-chunks of 12 blocks over 4 devices" in err1[0]
    assert "Sharding super-chunks of 12 blocks over 4 devices" in err2[0]
    b1, b2 = one.read_bytes(), two.read_bytes()
    assert len(b1) > 20000 and b1 == b2
    _ref("rx_fm", lambda pid: argv + [str(ref)], devices=4, extra=env)
    want = np.fromfile(ref, np.int16).astype(np.int64)
    got = np.frombuffer(b1, np.int16).astype(np.int64)
    assert want.size == got.size
    assert np.abs(want - got).max() <= 1
