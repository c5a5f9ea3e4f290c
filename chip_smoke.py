#!/usr/bin/env python3
"""Drive the PyTorch port's rx_fm chains, rx_power, its I/Q sources,
rx_channels and its sharded and multi-process paths on one CUDA card and
check them.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (nvcc); it builds the kernels from
``rx_tools_tpu_torch/kernels/csrc`` and exits non-zero, printing no
result, when anything fails — including when there is no CUDA device or
no checkout around it.

Phases, in order:

1. the card (``nvidia-smi``), the CUDA version, the kernel build;
2. every kernel against its plain PyTorch version on the card, at the CLI
   geometry (D = 6, 8208-sample blocks, 16 a chunk) and at BASELINE
   config #1 (D = 14, 258048-sample blocks, 12 a chunk): the capture head
   in its three layouts (K1, K3, K4) bit for bit, the fused front (K2) at
   the reference's K2 tolerances with its ulp distance reported; each
   timed with CUDA events at config #1 (median of rounds after warmup,
   launches queued behind a device-side sleep so host overhead is not
   timed, inputs rotated through more than the 50 MB L2); the edge cases
   of the tiled kernels (views off 16-byte alignment, one block, the
   fused kernel's ticket reset and grid-size independence); the head's
   seven matrix forms (``ops/frontend_mxu.py``: the reference's float32,
   int16, int8, bf16, thin and convolution products, library calls on
   the card), each held to its class against the plain version (bitwise,
   rtol 2e-5 / atol 5e-3, or the bf16 class) and timed, one JSON line a form with its modelled
   traffic and CUDA kernels a call; K1/K3/K4's library time is the
   fastest bitwise-exact form's; K2 in its planned wave of persistent
   CTAs against one CTA a tile; a size sweep of K1 and K2 at 1, 12 and 48
   blocks with a least-squares fit of fixed cost and streaming rate;
3. the main path: config #1 WBFM (2.4 Msps, the port's synth=fm with a
   1 kHz tone, 8 chunks, ~10 s of signal) through ``ChunkedFmRunner``
   (scan engine) — K1 must launch, the tone must come back, and the PCM
   must match the same input through the port on the CPU (same count,
   at most 1 LSB apart); the scan engine against per-block stepping on
   the card is reported (bitwise or not, at most 1 LSB required);
4. the fused path: the same input through the flat engine
   (``fm_chunk_step``) with ``fused=True`` — K2 must launch, audio held to
   the scan path at the flat engine's tolerance (rtol 1e-4, atol 0.02);
5. the CLI: ``rx_fm -M wbfm`` on a synth source, 64 blocks — K1 must
   launch, the tone must come back;
6. ``int_deemph`` (the integer tier's de-emphasis, a port-only kernel)
   bit for bit against its host walk at the wbfm block (1368 samples), on
   each input class: uniform noise at a = 13 (the kernels line's time,
   on the inputs it has always had), one sample, the 64 real
   ``--int-audio`` blocks of phase 7's wbfm synth (``models/fmint.py``
   stepped as the CLI sets it up; phase 7 holds its PCM to the CLI's
   bytes), silence, a = 75 and a = 2, and the 64-bit walk; one
   JSON line a class with its CUDA-event time, the segment plan (S, L, W)
   and the segments and samples the ordered fallback walked;
7. the CLI paths of the rest of rx_fm, each on the card and then on the
   CPU from the same seeded synth (same PCM count, at most 1 LSB apart):
   BASELINE config #2 (``-M nbfm -s 96k -r 48k -F 9 -l 10``, D = 16 in 4
   fifth-order passes, 800 Hz tone back); config #3 (``-M am -s 24k -E dc
   -E offset``, D = 42, K1 launched with ``rotate=False``, 600 Hz back) and
   again with ``-E rdc``; ``-E hq`` at the wbfm preset; ``--int-audio`` at
   the wbfm preset (card bytes identical to CPU bytes, ``int_deemph``
   launched, the card's wall time printed); ``-b 1`` against the chunked
   runner (identical bytes); an interrupted run with ``--checkpoint``
   resumed with ``--resume`` (identical to an uninterrupted run; the
   card's checkpoint loads on the CPU); scanning two ``-f`` with ``-l``,
   the first silent (a hop counted, audio emitted);
8. rx_power (no hand-written kernel on its path: the float tier's FFT is
   cuFFT through ``torch.fft``, ``--int-fft`` int32 torch ops), each CLI
   run on the card and then on the CPU from one seeded synth, the rows
   compared from column 2 on (float: columns 2-5 identical, dB within 0.02
   wherever the CPU's lies within 60 dB of its row's peak, ``-inf`` alike;
   ``--int-fft``: identical): BASELINE config #4 (one 2048-bin hop, the
   peak in the strongest tone's bin); config #5 (402 hops over 100M-1G,
   three emitters each 15 dB over the median floor) in both tiers; ``-F
   9``, ``-P`` and giant bins; a checkpoint written on the card, loaded
   and resumed on the CPU; then, with CUDA events, ``sweep_step`` and
   ``int_sweep_powers`` at config #5's shape and at the FFT-integration
   shape (16.8 M complex samples), with their rates, bounds and CUDA
   kernels a call, and config #5's CLI split into host read, device step
   and CSV flush;
9. sources on the card (no kernel of their own; K1 runs behind each rx_fm
   path): the port's native library and the fake SoapySDR
   (``tests/fake_soapy.cpp``) built with g++ into ``build/``; the tensor
   codecs on the card bit for bit against NumPy over all of int16 and
   uint8; BASELINE config #1 (synth FM at 2.4 Msps) recorded by
   ``rx_sdr`` as CU8, CS8, CS12 and CF32 files and demodulated by ``rx_fm
   -M wbfm -s 2.4M``; ``rx_fm`` and ``rx_sdr`` from an rtl_tcp server on
   localhost and from the fake device; one ``rx_power`` sweep from the
   fake device (each rx_fm and rx_power run card vs CPU as in phases 7 and
   8, the tone back, K1 launched); then rx_sdr's host conversion rate
   (native codecs and NumPy), rx_fm's wall time on a 3 s CU8 capture of
   config #1 with and without the ``Feeder`` readahead, and the same run
   under ``RX_PROFILE`` with the trace's CUDA kernel time;
10. rx_channels (no hand-written kernel on its path: the reference
    package's channelizers reach no Pallas kernel; their products are
    cuBLAS float32, the PFB's FFT form cuFFT), each CLI run on the card and
    then on the CPU from one seeded synth scene (eight FM stations with 1
    kHz tones on the 64-channel grid of a 2.4 Msps capture, recorded once
    by ``rx_sdr`` to a CS16 file): ``-n 64 -M fm
    -A fast -c us -r 32k`` (BASELINE.md:34's configuration, time-major),
    ``-k`` with the eight stations at ``-D 16`` in both engines, ``-M raw``
    on the PFB (channel-major); the same file names, per channel the same
    count and at most 1 LSB apart, the tone back on each station's channel;
    ``RX_CHANNELS_CHUNK=1`` against chunked dispatch, identical bytes on the
    card.  Then, with CUDA events at bench.py's geometries,
    ``pfb_step_tmaj`` (D = 64, 524288-sample blocks) and
    ``channelize_step_tmaj`` (64 offsets, D = 16, 131072-sample blocks):
    ms a step, GB/s of int16 in, channel-realtime equivalents, byte bound,
    the host's enqueue time a step, CUDA kernels a step and the sum of
    their device times (``torch.profiler``); and ``rx_channels -n 64``'s
    wall time on 3.28 s of the scene (the recording repeated), chunked and
    per-block;
11. ``parallel/`` on one card: ``time_sharded_fm`` at BASELINE config #1
    (4 shards of 12 258048-sample blocks on ``[cuda:0] * 4``, warmup 2, a
    first super-chunk and a continuation) against the unsharded
    ``scan_fm_blocks`` of the same blocks on the card (same counts, rtol
    1e-4, atol 0.1) and against the same calls on the CPU (1 LSB), K1
    launched once a shard and once a halo replay; hop sharding at config
    #5's shape on ``[cuda:0] * 2`` (float at rtol 1e-6 with samples equal,
    ``--int-fft`` bitwise); channel sharding at D = 64, 524288-sample blocks
    on ``[cuda:0] * 4`` (station channels within 1 LSB of ``pfb_step`` and
    of the CPU); then the CLIs as two rank processes sharing the card over
    gloo, each against one rank: ``rx_fm -M wbfm -E shard`` on a config #1
    file (1 LSB from the same two ranks on the CPU, tone back), ``-M fm -E
    shard`` (the streaming bytes), ``rx_power`` config #5 in both tiers and
    ``rx_channels -n 64`` (station channels within 2 LSB of ``RX_PFB=cm``);
    each sharded step timed against its unsharded step with CUDA events,
    and the CLIs' wall times at 2 ranks and 1; ``entry.dryrun_multichip(4)``
    (the twin of ``__graft_entry__.py``'s dry run: time shards three ways,
    channel and hop sharding on tiny shapes) on ``[cuda:0] * 4`` with its
    K1 launches and wall time, its outputs against the same run on the CPU
    (counts and shapes exact, FM audio at rtol 1e-4 / atol 0.1, the PFB at
    rtol / atol 2e-4 of each channel's peak, the sweep at rtol 1e-6);
12. the hardware-soak twin, ``python -m rx_tools_tpu_torch.hw_soak``: exit
    2 with no radio, exit 0 against a two-connection rtl_tcp server on
    localhost serving phase 9's config #1 CU8 recording (its check lines
    printed, its CLIs on the card);
13. one JSON line listing every kernel entry point, then the result line.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

AUDIO_RATE = 32_000
CAPTURE_RATE = 2_400_000              # BASELINE config #1
STATION = 100.3e6
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                # H100 SXM, float32 outside tensor cores


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@contextlib.contextmanager
def env_var(name, value):
    """``os.environ[name] = value`` inside the block (``None``: unset)."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name = value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def tone_hz(pcm, rate=AUDIO_RATE, skip=2000):
    a = pcm[skip:].astype("float64")
    a -= a.mean()
    import numpy as np
    sp = np.abs(np.fft.rfft(a * np.hanning(a.size))) ** 2
    return float(np.fft.rfftfreq(a.size, 1 / rate)[np.argmax(sp)])


def bound(bytes_moved, ops):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def ulp_distance(a, b):
    import numpy as np
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max()) if ai.size else 0


# the head's matrix forms in ``ops/frontend_mxu.py``: (form, function,
# class against ``capture_head_plain``); the classes are the reference
# tests' (tests/test_frontend_mxu.py:29, 138-212)
HEAD_FORMS = (("mm", "capture_frontend_mm", "float"),
              ("mm_i16", "capture_frontend_mm_i16", "bitwise"),
              ("mm_i16_2", "capture_frontend_mm_i16_2", "bitwise"),
              ("mm_i8", "capture_frontend_mm_i8", "bitwise"),
              ("mm_bf16", "capture_frontend_mm_bf16", "bf16"),
              ("t2", "capture_frontend_t2", "float"),
              ("conv", "capture_frontend_conv", "float"))
FORM_CLASS = {"bitwise": "bitwise", "float": "within rtol 2e-5 / atol 5e-3",
              "bf16": "bf16 class"}


def traffic_bytes(fn, *args):
    """``(bytes, ops)`` that the eager torch ops of ``fn(*args)`` move: each
    op's tensor inputs read once and its outputs written once; an op whose
    outputs all alias its inputs (a view) moves nothing."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    moved = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            src = {t.untyped_storage().data_ptr() for t in ins}
            if not all(t.untyped_storage().data_ptr() in src for t in outs):
                moved.append(sum(t.numel() * t.element_size()
                                 for t in ins + outs))
            return out

    with Count():
        fn(*args)
    return sum(moved), len(moved)


def head_forms(frontend_mxu, bufs, d, card):
    """Each of the head's matrix forms at the config #1 chunk: held to its
    class against the plain version (the bf16 probe on its reference
    test's input, d = 14, K = 768, int16 in +-2000 from seed 31; its
    relative error at the config #1 chunk, where the reference's probe
    exceeds that bound too, is printed beside it), timed
    with CUDA events over ``bufs``, its modelled traffic and CUDA kernels
    a call; one JSON line each.  Returns the fastest bitwise-exact form's
    (name, ms)."""
    import numpy as np
    import torch
    from rx_tools_tpu_torch.kernels.timing import time_ms

    x0 = bufs[0][0]
    plain = frontend_mxu.capture_head_plain(x0, d)
    rng = np.random.default_rng(31)
    xb = torch.from_numpy(rng.integers(-2000, 2000, 2 * d * 32 * 24).astype(
        np.int16)).to(x0.device)
    plain_b = frontend_mxu.capture_head_plain(xb, d)
    best = None
    for form, name, cls in HEAD_FORMS:
        fn = getattr(frontend_mxu, name)
        got = fn(x0, d)
        err = max(float((g - w).abs().max()) for g, w in zip(got, plain))
        line = {"form": form, "function": name, "class": FORM_CLASS[cls]}
        if cls == "bitwise":
            met = all(torch.equal(g, w) for g, w in zip(got, plain))
        elif cls == "float":
            met = all(torch.allclose(g, w, rtol=2e-5, atol=5e-3)
                      for g, w in zip(got, plain))
        else:
            rel = max(float(((g - w).abs() / (w.abs() + 1.0)).max())
                      for g, w in zip(fn(xb, d), plain_b))
            met = rel < 0.05
            line["max_rel_err"] = rel
            line["max_rel_err_config1"] = max(
                float(((g - w).abs() / (w.abs() + 1.0)).max())
                for g, w in zip(got, plain))
        ms = time_ms(fn, bufs)
        traffic, ops = traffic_bytes(fn, x0, d)
        line.update(met=met, max_abs_err=err, ms=ms,
                    traffic_mb=traffic / 1e6, torch_ops=ops,
                    kernels=cuda_kernels_per_call(fn, (x0, d)), card=card)
        print(json.dumps(line))
        if not met:
            fail(f"head form {form} misses its class ({FORM_CLASS[cls]})")
        if cls == "bitwise" and (best is None or ms < best[1]):
            best = (form, ms)
    return best


POWER_SRC = "synth=tone,det=1,seed=2,carrier=101M|104M,amp=0.4|0.3,noise=0.02"
# BASELINE config #5's scene: three emitters in hops far apart
POWER_SCENE = ("synth=tone,det=1,seed=4,carrier=150.3M|480.7M|901.1M,"
               "amp=0.4|0.4|0.4,noise=0.01")


def csv_rows(path):
    """rx_power CSV rows from column 2 on (the timestamp differs)."""
    with open(path) as f:
        return [line.strip().split(", ")[2:] for line in f]


def rows_agree(what, gpu, cpu, exact):
    """Card rows against CPU rows; returns the largest dB difference over
    the compared bins."""
    import numpy as np
    if len(gpu) != len(cpu) or not gpu:
        fail(f"{what}: card {len(gpu)} vs CPU {len(cpu)} CSV rows")
    if exact:
        if gpu != cpu:
            fail(f"{what}: card and CPU --int-fft rows differ")
        return 0.0
    worst = 0.0
    for g, c in zip(gpu, cpu):
        if g[:4] != c[:4] or len(g) != len(c):
            fail(f"{what}: columns 2-5 differ: {g[:4]} vs {c[:4]}")
        gd, cd = np.array(g[4:], float), np.array(c[4:], float)
        if not (np.isneginf(gd) == np.isneginf(cd)).all():
            fail(f"{what}: -inf bins differ")
        fin = np.isfinite(cd)
        near = fin & (cd >= cd[fin].max(initial=-np.inf) - 60.0)
        worst = max(worst, float(np.abs(gd[near] - cd[near]).max(initial=0)))
    if worst > 0.02:
        fail(f"{what}: card and CPU dB differ by {worst}")
    return worst


def cuda_kernels_per_call(fn, args):
    """CUDA kernels one call launches, from a ``torch.profiler`` trace
    (copies and fills not counted); None when the profiler cannot trace
    the card or the trace has no device events."""
    return cuda_kernel_profile(fn, args)[0]


def cuda_kernel_profile(fn, args):
    """``(kernels, kernel_ms)`` of one call from a ``torch.profiler`` trace:
    the CUDA kernels it launches (copies and fills not counted) and the sum
    of their device times; ``(None, None)`` when the trace has no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"torch.profiler could not trace the card: {e}")
        return None, None
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    if not dev:
        return None, None
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def rx_power_phase(dev, counted, tmp):
    """Phase 8: rx_power on the card against the CPU, then its timings."""
    import math

    import numpy as np
    import torch
    from rx_tools_tpu_torch.apps import rx_power
    from rx_tools_tpu_torch.kernels.timing import time_ms
    from rx_tools_tpu_torch.models import powerscan
    from rx_tools_tpu_torch.stream import checkpoint

    def run(args, name, cpu=False):
        with env_var("RX_PLATFORM", "cpu" if cpu else None):
            rc = rx_power.main(args + [str(tmp / name)])
        if rc != 0:
            fail(f"rx_power {' '.join(args)} exited {rc}")
        return csv_rows(tmp / name)

    def card_vs_cpu(what, args, exact=False):
        t = time.perf_counter()
        gpu, counts = counted(lambda: run(args, "gpu.csv"))
        gpu_s = time.perf_counter() - t
        cpu = run(args, "cpu.csv", cpu=True)
        worst = rows_agree(what, gpu, cpu, exact)
        print(f"{what}: {len(gpu)} rows x {len(gpu[0]) - 4} dB values, "
              f"card vs CPU {'identical' if exact else f'max |dB| {worst}'}"
              f", card run {gpu_s:.2f} s, launches {counts}")
        return gpu

    # (a) BASELINE config #4: one hop at 2 Msps, 2048 bins
    c4 = card_vs_cpu("config #4 (-f 99M:101M:1k -w hamming)", [
        "-f", "99M:101M:1k", "-w", "hamming", "-1", "-S", "0", "-d",
        "synth=tone,det=1,seed=4,carrier=100.3M|99.4M|100.7M,"
        "amp=0.5|0.1|0.2,noise=0.01"])
    lo, step = float(c4[0][0]), float(c4[0][2])
    dbs = np.array(c4[0][4:-1], float)
    peak_hz = lo + int(np.argmax(dbs)) * step
    if len(c4) != 1 or dbs.size != 2048 or abs(peak_hz - 100.3e6) > step:
        fail(f"config #4: {len(c4)} rows, {dbs.size} bins, peak at "
             f"{peak_hz} Hz (tone at 100.3 MHz)")
    print(f"  config #4 peak at {peak_hz:.1f} Hz (tone 100300000, bin "
          f"{step:.2f} Hz)")

    # (b) BASELINE config #5: 402 hops, crop 20 %, three emitters
    c5_args = ["-f", "100M:1G:10k", "-c", "20%", "-1", "-S", "0", "-d",
               POWER_SCENE]
    c5 = card_vs_cpu("config #5 (-f 100M:1G:10k -c 20%)", c5_args)
    freqs, dbs = [], []
    for row in c5:
        lo, step = float(row[0]), float(row[2])
        freqs += [lo + (i + 0.5) * step for i in range(len(row) - 4)]
        dbs += [float(v) for v in row[4:]]
    freqs, dbs = np.array(freqs), np.array(dbs)
    floor = float(np.median(dbs))
    over = {}
    for c in (150.3e6, 480.7e6, 901.1e6):
        near = np.abs(freqs - c) < 60e3
        over[c] = float(dbs[near].max() - floor) if near.any() else -1e9
    if len(c5) != 402 or min(over.values()) < 15:
        fail(f"config #5: {len(c5)} rows, emitters over the floor {over}")
    print(f"  config #5: emitters over the {floor:.2f} dB median floor: "
          + ", ".join(f"{c / 1e6:.1f} MHz +{v:.1f} dB"
                      for c, v in over.items()))

    # (c) --int-fft at config #5: identical rows
    card_vs_cpu("config #5 --int-fft", c5_args + ["--int-fft"], exact=True)

    # (d) -F 9 (fifth-order cascade + droop), -P, giant bins
    card_vs_cpu("-F 9 (-f 100M:100.5M:1k)", [
        "-f", "100M:100.5M:1k", "-F", "9", "-1", "-S", "0", "-d",
        "synth=tone,det=1,seed=5,carrier=100.2M,amp=0.4,noise=0.01"])
    card_vs_cpu("-P (-f 100M:110M:10k -w blackman-harris)", [
        "-f", "100M:110M:10k", "-P", "-w", "blackman-harris", "-1", "-S",
        "0", "-d", POWER_SRC])
    card_vs_cpu("giant bins (-f 100M:110M:1M)", [
        "-f", "100M:110M:1M", "-1", "-S", "0", "-d", POWER_SRC])

    # (e) a checkpoint written on the card loads and resumes on the CPU
    ck_args = ["-f", "100M:104M:50k", "-S", "0", "-d", POWER_SRC]
    for tier in ([], ["--int-fft"]):
        ck = tmp / "power_ck.npz"
        counted(lambda: run(ck_args + tier + ["-i", "1h", "-e", "0.001",
                                              "--checkpoint", str(ck)],
                            "none.csv"))
        cfg = powerscan.PowerConfig(bin_e=6)
        tmpl = (powerscan.SweepAccum(np.zeros((2, 64), np.int64),
                                     np.zeros(2, np.int64)) if tier
                else powerscan.new_sweep_accum(2, cfg, "cpu"))
        acc, meta = checkpoint.load_checkpoint(str(ck), tmpl)
        resumed = run(ck_args + tier + ["-1", "--resume", str(ck)],
                      "resumed.csv", cpu=True)
        if (meta["int_fft"] != bool(tier) or int(acc.samples.max()) != 128
                or [r[3] for r in resumed] != ["256", "256"]):
            fail(f"checkpoint {tier}: meta {meta}, samples "
                 f"{acc.samples}, resumed {[r[3] for r in resumed]}")
        print(f"checkpoint {' '.join(tier) or 'float'}: one sweep saved on "
              f"the card (128 samples a hop), resumed on the CPU to 256")

    # (f) timing: the device steps at config #5's shape and at the FFT
    # integration shape (2048 bins x 512 segments x 16 hops; the int tier's
    # guard eff*32768 < 2**31 caps a hop at 15 segments of 2048, so the
    # same 16.8 M samples run there as 1024 hops of 8 segments)
    gen = torch.Generator(device=dev).manual_seed(3)
    for shape, tier, h, bin_e, segs, n_in in (
            ("config5", "float", 402, 9, 16, 5),
            ("config5", "int", 402, 9, 16, 5),
            ("integration", "float", 16, 11, 512, 2),
            ("integration", "int", 1024, 11, 8, 2)):
        bin_len = 1 << bin_e
        buf_len = 2 * bin_len * segs
        cfg = powerscan.PowerConfig(bin_e=bin_e, buf_len=buf_len)
        ins = [(torch.randint(-20000, 20000, (h, buf_len), generator=gen,
                              device=dev, dtype=torch.int32)
                .to(torch.int16),) for _ in range(n_in)]
        if tier == "float":
            acc = powerscan.new_sweep_accum(h, cfg, dev)

            def fn(b, cfg=cfg, acc=acc):
                return powerscan.sweep_step(cfg, acc, b)
            io_bytes = 2 * h * buf_len + 2 * (4 * h * bin_len + 4 * h)
        else:
            def fn(b, cfg=cfg):
                return powerscan.int_sweep_powers(cfg, b)
            io_bytes = 2 * h * buf_len + 4 * bin_len + 4 * h * segs * bin_len
        ms = time_ms(fn, ins, rounds=5, iters=10)
        n_fft = h * segs
        ops = 5 * bin_len * math.log2(bin_len) * n_fft
        bound_ms, bound_by = bound(io_bytes, ops)
        rec = {"rx_power": f"{tier} sweep step", "shape": shape,
               "hops": h, "bins": bin_len, "segments": segs,
               "complex_samples": h * segs * bin_len, "ms": ms,
               "gcsps": h * segs * bin_len / ms / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "cuda_kernels_per_call": cuda_kernels_per_call(fn, ins[0])}
        print(json.dumps(rec))
        del ins

    # config #5 through the CLI, a few sweeps, split into host read
    # (retune + synth reads), device step and CSV flush (host clocks; the
    # device step synchronised)
    for tier, step_name in (([], "sweep_step"), (["--int-fft"], "_int_sweep")):
        spans = {"read": [], "step": [], "flush": []}
        owner = powerscan if step_name == "sweep_step" else rx_power
        saved = {"read": (rx_power, "read_sweep"),
                 "step": (owner, step_name),
                 "flush": (rx_power, "_flush_csv")}
        originals = {k: getattr(m, n) for k, (m, n) in saved.items()}

        def timed(key):
            inner = originals[key]

            def wrapper(*a, **kw):
                t = time.perf_counter()
                r = inner(*a, **kw)
                torch.cuda.synchronize()
                spans[key].append(time.perf_counter() - t)
                return r
            return wrapper

        for key, (m, n) in saved.items():
            setattr(m, n, timed(key))
        try:
            t = time.perf_counter()
            counted(lambda: run(["-f", "100M:1G:10k", "-c", "20%", "-S", "0",
                                 "-i", "0.001", "-e", "4", "-d", POWER_SCENE]
                                + tier, "timed.csv"))
            wall = time.perf_counter() - t
        finally:
            for key, (m, n) in saved.items():
                setattr(m, n, originals[key])
        rec = {"rx_power": "config #5 CLI", "tier": tier[0] if tier
               else "float", "wall_s": wall, "sweeps": len(spans["step"]),
               "read_s": spans["read"], "step_s": spans["step"],
               "flush_s": spans["flush"]}
        print(json.dumps(rec))
        if not spans["step"]:
            fail(f"config #5 CLI {tier}: no sweep completed")


class RtlTcpMock:
    """The server side of the rtl_tcp protocol on localhost, for
    ``connections`` clients in turn: to each the 12-byte header,
    ``payload`` as the CU8 stream, EOF, then the 5-byte commands the
    client sent are kept until it closes."""

    def __init__(self, payload, connections=1):
        import socket
        import threading
        self.payload, self.commands = payload, []
        self.connections = connections
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(connections)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            for _ in range(self.connections):
                conn, _ = self._lsock.accept()
                self._serve_one(conn)
        finally:
            self._lsock.close()

    def _serve_one(self, conn):
        import socket
        import struct
        conn.settimeout(30.0)
        buf = b""
        try:
            try:
                conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
                conn.sendall(self.payload)
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass          # the client left before the payload's end
            while True:
                try:
                    chunk = conn.recv(4096)
                except OSError:
                    break     # a client that leaves data unread resets
                if not chunk:
                    break
                buf += chunk
        finally:
            conn.close()
        self.commands += [struct.unpack(">BI", buf[i:i + 5])
                          for i in range(0, len(buf) - 4, 5)]

    def join(self):
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            fail("the rtl_tcp mock did not finish")


def sources_phase(counted, tmp):
    """Phase 9: every I/Q source and wire format into the card.  Returns
    the bytes of its config #1 CU8 recording (0.25 s at 2.4 Msps)."""
    import ctypes

    import numpy as np
    import torch
    from rx_tools_tpu_torch import native
    from rx_tools_tpu_torch.apps import rx_fm, rx_power, rx_sdr
    from rx_tools_tpu_torch.iq import formats, soapy
    from rx_tools_tpu_torch.native import build as native_build

    # (a) the native library and the fake SoapySDR, two g++ at once
    t_phase = t = time.perf_counter()
    fake_lib = ROOT / "build" / "fake_soapy" / "libfakesoapy.so"
    fake_lib.parent.mkdir(parents=True, exist_ok=True)
    gxx = subprocess.Popen(["g++", "-shared", "-fPIC", "-O1", "-o",
                            str(fake_lib), str(ROOT / "tests" /
                                               "fake_soapy.cpp")])
    try:
        native_build.build()
    finally:
        rc = gxx.wait(timeout=300)
    if rc != 0 or not native.available():
        fail(f"g++ builds: fake SoapySDR rc {rc}, native library loaded "
             f"{native.available()}")
    lib = ctypes.CDLL(str(fake_lib))
    soapy._bind(lib)
    soapy._LIB, soapy._TRIED = lib, True
    print(f"native library and fake SoapySDR built in "
          f"{time.perf_counter() - t:.1f} s (g++)")

    def numpy_path():
        return patched(native, "_LIB", None)

    # (b) the tensor codecs on the card against NumPy, all of int16 and
    # uint8; the native codecs against NumPy (they differ only where the
    # C's double narrowing leaves NumPy's float32, two CU8 inputs)
    all16 = np.arange(-32768, 32768, dtype=np.int16)
    u8 = np.arange(256, dtype=np.uint8)
    rng = np.random.default_rng(21)
    cases = {
        "cs16_to_cs8": all16, "cs16_to_cu8": all16, "cs16_to_cf32": all16,
        "cs16_rescale8": all16, "cs16_to_cs12": all16,
        "cu8_to_cs16": u8, "cs8_to_cs16": u8.view(np.int8),
        "cs12_to_cs16": rng.integers(0, 256, 3 << 20, dtype=np.uint8),
        "cf32_to_cs16": np.concatenate([
            all16 / np.float32(32767.0), (rng.standard_normal(1 << 20)
                                          * 0.6).astype(np.float32)]),
    }
    native_off = {}
    for name, x in cases.items():
        fn = getattr(formats, name)
        with numpy_path():
            want = fn(x)
        got = fn(torch.from_numpy(x.copy()).to("cuda"))
        if got.device.type != "cuda" or not np.array_equal(got.cpu().numpy(),
                                                           want):
            fail(f"tensor codec {name} on the card differs from NumPy")
        off = np.flatnonzero(fn(x) != want)         # numpy input: native
        native_off[name] = x[off].tolist() if name == "cs16_to_cu8" \
            else off.size
    if native_off.pop("cs16_to_cu8") not in ([], [-13158, 19609]) or any(
            native_off.values()):
        fail(f"native codecs off NumPy beyond the known CU8 pair: "
             f"{native_off}")
    print(f"tensor codecs on the card: {len(cases)} bitwise against NumPy "
          "(int16 and uint8 in full); the native codecs equal NumPy but at "
          "CU8 inputs -13158 and 19609 (C double vs float32)")

    # (c) BASELINE config #1 recorded by rx_sdr in four formats, then
    # demodulated by rx_fm -M wbfm on the card and on the CPU.  The CLI's
    # planner takes D = 1M // rate_in + 1, so 2.4 Msps reaches it as -s
    # 2.4M (D = 1); phase 3 drives config #1's D = 14 geometry.
    cfg1 = ("synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,seed=7,"
            f"carrier={STATION:.0f}")
    tune = STATION + CAPTURE_RATE / 4 + 16e3    # where rx_fm -M wbfm tunes
    wbfm = ["-f", f"{STATION:.0f}", "-M", "wbfm", "-s", "2.4M"]

    def record(fmt, n, query=cfg1):
        path = tmp / f"cfg1.{fmt.lower()}"
        if rx_sdr.main(["-f", f"{tune:.0f}", "-s", "2.4M", "-d", query,
                        "-n", str(n), "-F", fmt, str(path)]) != 0:
            fail(f"rx_sdr -F {fmt} failed")
        return path

    def rx_fm_pcm(args, cpu):
        out = tmp / ("cpu.raw" if cpu else "gpu.raw")
        with env_var("RX_PLATFORM", "cpu" if cpu else None):
            if rx_fm.main(args + [str(out)]) != 0:
                fail(f"rx_fm {' '.join(args)} exited non-zero")
        return np.fromfile(out, np.int16)

    def fm_card_vs_cpu(what, args, tone=True, serve=None):
        """rx_fm on the card (counted) and on the CPU: same count, at most
        1 LSB, K1 launched; ``serve()`` gives the source's args anew."""
        gpu, counts = counted(lambda: rx_fm_pcm(
            args + (serve() if serve else []), cpu=False))
        cpu = rx_fm_pcm(args + (serve() if serve else []), cpu=True)
        if gpu.size != cpu.size or gpu.size < 4000:
            fail(f"{what}: card {gpu.size} vs CPU {cpu.size} PCM samples")
        lsb = int(np.abs(gpu.astype(int) - cpu.astype(int)).max())
        hz = tone_hz(gpu) if tone else float("nan")
        if lsb > 1 or counts["capture_frontend_mm_pallas"] <= 0 or (
                tone and abs(hz - 1000.0) > 10):
            fail(f"{what}: {lsb} LSB apart, tone {hz} Hz, launches {counts}")
        print(f"{what}: {gpu.size} PCM samples, card vs CPU max |diff| {lsb}"
              f" LSB, tone {hz:.1f} Hz, K1 launches "
              f"{counts['capture_frontend_mm_pallas']}")

    n_short = 600_000                               # 0.25 s of config #1
    caps = {fmt: record(fmt, n_short) for fmt in ("CU8", "CS8", "CS12",
                                                   "CF32")}
    for fmt, path in caps.items():
        fm_card_vs_cpu(f"config #1 {fmt} file (rx_sdr -F {fmt}, rx_fm)",
                       wbfm + ["-d", f"file={path},format={fmt},rate=2.4M"])

    # (d) an rtl_tcp server on localhost: rx_fm to its EOF, rx_sdr
    cu8 = caps["CU8"].read_bytes()
    mocks = []

    def serve():
        mocks.append(RtlTcpMock(cu8))
        return ["-d", f"rtltcp=127.0.0.1:{mocks[-1].port}"]

    fm_card_vs_cpu("rtl_tcp mock (rx_fm -M wbfm to EOF)", wbfm, serve=serve)
    out = tmp / "tcp.cs16"
    if rx_sdr.main(serve() + ["-f", "100M", "-n", str(n_short), "-F",
                              "CS16", str(out)]) != 0:
        fail("rx_sdr from the rtl_tcp mock failed")
    for m in mocks:
        m.join()
    want = formats.cu8_to_cs16(np.frombuffer(cu8, np.uint8))
    if not np.array_equal(np.fromfile(out, np.int16), want):
        fail("rx_sdr from the rtl_tcp mock: bytes differ from the CU8 "
             "stream widened")
    if not all((1, int(tune)) in m.commands for m in mocks[:2]):
        fail(f"rx_fm did not tune the rtl_tcp mock ({mocks[0].commands})")
    print(f"rtl_tcp mock: rx_sdr -F CS16 = the stream widened "
          f"({n_short} samples); rx_fm tuned the server to {tune:.0f} Hz")

    # (e) the fake SoapySDR device (it never ends its stream: --blocks,
    # -n): rx_fm, rx_sdr -I CS12 -F CS16, one rx_power sweep
    fm_card_vs_cpu("fake SoapySDR device (rx_fm -M wbfm --blocks 64)",
                   wbfm + ["-d", "driver=rtlsdr", "--blocks", "64"],
                   tone=False)
    if rx_sdr.main(["-d", "driver=rtlsdr,native=CS12", "-f", "100M", "-I",
                    "CS12", "-F", "CS16", "-n", "65536", str(out)]) != 0:
        fail("rx_sdr from the fake device failed")
    k = np.arange(65536)
    i12, q12 = k & 0xFFF, ~k & 0xFFF
    wire = np.stack([i12 & 0xFF, ((i12 >> 8) & 0x0F) | ((q12 & 0x0F) << 4),
                     (q12 >> 4) & 0xFF], -1).reshape(-1).astype(np.uint8)
    if not np.array_equal(np.fromfile(out, np.int16),
                          formats.cs12_to_cs16(wire)):
        fail("rx_sdr -I CS12 -F CS16 from the fake device: not the unpack")

    def power_rows(cpu):
        path = tmp / ("cpu.csv" if cpu else "gpu.csv")
        with env_var("RX_PLATFORM", "cpu" if cpu else None):
            if rx_power.main(["-f", "100M:104M:50k", "-1", "-S", "0", "-d",
                              "driver=rtlsdr", str(path)]) != 0:
                fail("rx_power from the fake device failed")
        return csv_rows(path)

    gpu, _ = counted(lambda: power_rows(False))
    worst = rows_agree("rx_power from the fake device", gpu,
                       power_rows(True), exact=False)
    print(f"fake SoapySDR device: rx_sdr -I CS12 -F CS16 = the wire unpack "
          f"(65536 samples); rx_power {len(gpu)} rows, card vs CPU max |dB| "
          f"{worst}")

    # (f) timings on a 3 s CU8 capture of config #1 (the short one
    # repeated).  rx_sdr's host conversion: formats.convert on its
    # 131072-sample blocks of the capture widened to CS16, through the
    # native codecs and NumPy, three passes each
    big = tmp / "cfg1_3s.cu8"
    reps = -(-3 * CAPTURE_RATE // n_short)
    big.write_bytes(cu8 * reps)
    seconds = reps * n_short / CAPTURE_RATE
    cs16 = formats.cu8_to_cs16(np.fromfile(big, np.uint8))
    blocks = [cs16[i:i + 262144] for i in range(0, cs16.size, 262144)]
    rates = {}
    for fmt in ("CU8", "CS8", "CS12", "CF32"):
        for path, ctx in (("native", contextlib.nullcontext()),
                          ("numpy", numpy_path())):
            with ctx:
                for _ in range(3):
                    t = time.perf_counter()
                    n_out = sum(len(formats.array_to_bytes(
                        formats.convert(b, "CS16", fmt), fmt))
                        for b in blocks)
                    rates.setdefault(f"{fmt} {path}", []).append(
                        n_out / (time.perf_counter() - t) / 1e6)
    print(json.dumps({"rx_sdr host conversion": "CS16 -> format, MB/s out, "
                      "three passes", "samples": cs16.size // 2,
                      "mb_per_s": rates}))

    # rx_fm on the 3 s capture with and without the Feeder readahead
    # (alternated); then 1 s of it under RX_PROFILE
    args = wbfm + ["-d", f"file={big},format=CU8,rate=2.4M"]
    runs, pcm = {"feeder": [], "no feeder": []}, {}
    for mode in ("feeder", "no feeder", "no feeder", "feeder"):
        ctx = (patched(native, "Feeder", lambda *a, **kw: None)
               if mode == "no feeder" else contextlib.nullcontext())
        with ctx:
            t = time.perf_counter()
            pcm[mode], _ = counted(lambda: rx_fm_pcm(args, cpu=False))
            runs[mode].append(time.perf_counter() - t)
    if not np.array_equal(pcm["feeder"], pcm["no feeder"]):
        fail("rx_fm's PCM differs with and without the Feeder")
    print(json.dumps({"rx_fm config #1 CU8 file": f"{seconds:.2f} s of "
                      "signal, -M wbfm -s 2.4M", "wall_s": runs,
                      "realtime_multiple": {m: [seconds / w for w in v]
                                            for m, v in runs.items()}}))
    # (a 1 s capture: a trace holds every torch op, tens of MB a second)
    one_s = tmp / "cfg1_1s.cu8"
    one_s.write_bytes(cu8 * 4)
    prof = tmp / "prof"
    with env_var("RX_PROFILE", str(prof)):
        t = time.perf_counter()
        counted(lambda: rx_fm_pcm(wbfm + ["-d", f"file={one_s},format=CU8,"
                                          "rate=2.4M"], cpu=False))
        wall = time.perf_counter() - t
    traces = list(prof.glob("rx_trace.*.json"))
    if len(traces) != 1:
        fail(f"RX_PROFILE wrote {len(traces)} traces")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    by_cat = {}
    for e in spans:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + e["dur"] / 1e3
    if not by_cat.get("kernel"):
        fail("the RX_PROFILE trace holds no CUDA kernel")
    traced_ms = (max(e["ts"] + e["dur"] for e in spans)
                 - min(e["ts"] for e in spans)) / 1e3
    print(json.dumps({"RX_PROFILE rx_fm config #1 CU8 file": "1.00 s of "
                      "signal; the runner's run traced (set-up and warmup "
                      "outside)",
                      "traced_ms": traced_ms, "cli_wall_s": wall,
                      "device_ms": by_cat,
                      "kernel_share_of_traced": by_cat["kernel"] / traced_ms,
                      "trace_mb": traces[0].stat().st_size / 1e6}))
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return cu8

# phase 10's scene: eight FM stations on the 64-channel grid of a 2.4 Msps
# capture at 98 MHz (channel k at 98 MHz + k * 37.5 kHz), each with a 1 kHz
# tone; 10 kHz deviation keeps each inside its channel
CH_CENTER = 98_000_000
CH_STATIONS = [CH_CENTER + k * 37_500 for k in (-29, -22, -13, -5, 3, 9, 17,
                                                 26)]
CH_SCENE = ("synth=fm,det=1,seed=11,audio=1k,dev=10k,amp=0.08,noise=0.001,"
            "carrier=" + "|".join(str(f) for f in CH_STATIONS))


def channels_phase(counted, tmp, timing=True):
    """Phase 10: rx_channels on the card against the CPU, then timings."""
    import numpy as np
    import torch
    from rx_tools_tpu_torch.apps import rx_channels, rx_sdr
    from rx_tools_tpu_torch.kernels.timing import time_ms
    from rx_tools_tpu_torch.models import channelizer, pfb

    t_phase = time.perf_counter()
    base = ["-f", str(CH_CENTER), "-s", "2.4M"]
    pfb64 = base + ["-n", "64", "-M", "fm", "-A", "fast", "-c", "us", "-r",
                    "32k"]
    mixer = base + ["-k", ",".join(str(f) for f in CH_STATIONS), "-D", "16",
                    "-M", "fm", "-A", "fast", "-c", "us", "-r", "32k"]

    def run(args, name, cpu=False, env=()):
        out = tmp / name
        with contextlib.ExitStack() as stack:
            stack.enter_context(env_var("RX_PLATFORM", "cpu" if cpu
                                        else None))
            for k, v in env:
                stack.enter_context(env_var(k, v))
            rc = rx_channels.main(args + [str(out)])
        if rc != 0:
            fail(f"rx_channels {' '.join(args)} exited {rc}")
        return {p.name: np.fromfile(p, np.int16)
                for p in sorted(out.glob("ch*.s16"))}

    def card_vs_cpu(what, args, env=(), tone=True):
        t = time.perf_counter()
        gpu, counts = counted(lambda: run(args, f"{what}-gpu", env=env))
        gpu_s = time.perf_counter() - t
        cpu = run(args, f"{what}-cpu", cpu=True, env=env)
        if list(gpu) != list(cpu) or not gpu:
            fail(f"{what}: file names differ ({len(gpu)} vs {len(cpu)})")
        lsb = {}
        for name, g in gpu.items():
            c = cpu[name]
            if g.size != c.size or g.size < 4000:
                fail(f"{what} {name}: card {g.size} vs CPU {c.size} samples")
            lsb[name] = int(np.abs(g.astype(int) - c.astype(int)).max())
        worst = max(lsb.values())
        if worst > 1:
            fail(f"{what}: card and CPU differ by more than 1 LSB: "
                 f"{ {k: v for k, v in lsb.items() if v > 1} }")
        tones = {}
        if tone:
            for f in CH_STATIONS:
                hits = [n for n in gpu if n.endswith(f"_{f}.s16")]
                if len(hits) != 1:
                    fail(f"{what}: no single channel file for {f} Hz")
                tones[f] = tone_hz(gpu[hits[0]], skip=4000)
            off = {f: hz for f, hz in tones.items() if abs(hz - 1000.0) > 10}
            if off:
                fail(f"{what}: tone not recovered on {off}")
        print(f"{what}: {len(gpu)} channels x {next(iter(gpu.values())).size}"
              f" PCM samples, card vs CPU max |diff| {worst} LSB, card run "
              f"{gpu_s:.2f} s, tones "
              f"{sorted(set(round(v, 1) for v in tones.values()))} Hz, "
              f"launches {counts}")
        return gpu

    # (a) the CLI: PFB at BASELINE.md:34's configuration (time-major), the
    # mixer in both engines, raw on the PFB's channel-major engine, and
    # chunked dispatch against per-block on the card; every run reads one
    # recording of the scene (six 131072-sample blocks, 0.33 s), so the
    # host synthesises it once
    block = 131072
    scene = tmp / "scene.cs16"
    if rx_sdr.main(["-f", str(CH_CENTER), "-s", "2.4M", "-d", CH_SCENE, "-n",
                    str(6 * block), "-F", "CS16", str(scene)]) != 0:
        fail("rx_sdr could not record the phase 10 scene")
    src = ["-d", f"file={scene},format=CS16,rate=2.4M"]
    card_vs_cpu("rx_channels -n 64 (tmaj)", pfb64 + src)
    card_vs_cpu("rx_channels -k x8 -D 16 (tmaj)", mixer + src)
    card_vs_cpu("rx_channels -k x8 -D 16 (RX_MIXER=cm)", mixer + src,
                env=[("RX_MIXER", "cm")])
    card_vs_cpu("rx_channels -n 64 -M raw (cm)",
                base + ["-n", "64", "-M", "raw", "-e", "0.05"] + src,
                tone=False)
    chunked = run(pfb64 + src, "chunked")
    per_block = run(pfb64 + src, "per-block",
                    env=[("RX_CHANNELS_CHUNK", "1")])
    if list(chunked) != list(per_block) or any(
            not np.array_equal(chunked[k], per_block[k]) for k in chunked):
        fail("RX_CHANNELS_CHUNK=1 differs from chunked dispatch on the card")
    print(f"RX_CHANNELS_CHUNK=1 vs chunked dispatch on the card: identical "
          f"bytes in all {len(chunked)} channels")
    if not timing:
        return

    # (b) timings at bench.py's geometries (bench.py:280-288, 328-340),
    # CUDA events over 5 distinct input blocks, state threaded
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(5)
    offs = tuple(float(v) for v in rng.choice(
        np.arange(-1_100_000, 1_100_000, 1000), 64, replace=False))
    for name, cfg, nb, init, step in (
            ("pfb_step_tmaj", pfb.PfbConfig(
                capture_rate=CAPTURE_RATE, n_channels=64, custom_atan=1,
                deemph_a=7, rate_out2=AUDIO_RATE), 524288,
             pfb.init_state_tmaj, pfb.pfb_step_tmaj),
            ("channelize_step_tmaj", channelizer.ChannelizerConfig(
                capture_rate=CAPTURE_RATE, offsets=offs, downsample=16,
                mode="fm", custom_atan=1, deemph_a=7, rate_out2=AUDIO_RATE),
             131072, channelizer.init_state_tmaj,
             channelizer.channelize_step_tmaj)):
        blocks = [(torch.randint(-16000, 16000, (2 * nb,), generator=gen,
                                 device=dev, dtype=torch.int32)
                   .to(torch.int16),) for _ in range(5)]
        holder = [init(cfg, dev)]

        def fn(blk, cfg=cfg, step=step, holder=holder):
            holder[0], audio, nv = step(cfg, holder[0], blk)
            return audio, nv

        ms = time_ms(fn, blocks, rounds=5, iters=20)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):          # under the launch queue's depth
            fn(*blocks[0])
        host_ms = (time.perf_counter() - t) * 1e3 / 5  # enqueue, no sync
        torch.cuda.synchronize()
        kernels, kernel_ms = cuda_kernel_profile(fn, blocks[0])
        audio, _ = fn(*blocks[0])
        out_bytes = audio.numel() * 4 + 4
        bound_ms, bound_by = bound(4 * nb + out_bytes, 0)
        gbs = 4 * nb / (ms * 1e-3) / 1e9
        print(json.dumps({
            "rx_channels step": name, "block_samples": nb, "channels": 64,
            "ms": ms, "gb_per_s_int16_in": gbs,
            "channel_rt_equiv": gbs * 1e9 / 4.0 / CAPTURE_RATE * 64,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "host_enqueue_ms": host_ms, "cuda_kernels_per_step": kernels,
            "kernel_ms_per_step": kernel_ms}))
        del blocks, holder

    # rx_channels -n 64 on 3.28 s of signal: the recording ten times over
    cap = tmp / "scene_3s.cs16"
    reps = 10
    cap.write_bytes(scene.read_bytes() * reps)
    seconds = reps * 6 * block / CAPTURE_RATE
    src = ["-d", f"file={cap},format=CS16,rate=2.4M"]
    walls = {}
    for chunk in ("8", "1", "1", "8"):
        t = time.perf_counter()
        counted(lambda: run(pfb64 + src, f"wall{chunk}",
                            env=[("RX_CHANNELS_CHUNK", chunk)]))
        walls.setdefault(f"RX_CHANNELS_CHUNK={chunk}", []).append(
            time.perf_counter() - t)
    print(json.dumps({"rx_channels -n 64 CS16 file": f"{seconds:.2f} s of "
                      "signal, -M fm -A fast -c us -r 32k", "wall_s": walls,
                      "realtime_multiple": {k: [seconds / w for w in v]
                                            for k, v in walls.items()}}))
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")


# phase 11's rank processes: each runs the port CLIs of a JSON plan in turn
# (one process group for all of them) and prints one RANK_RESULT line
RANK_CHILD = r"""
import importlib, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from rx_tools_tpu_torch.ops import frontend_mxu
from rx_tools_tpu_torch.parallel import multihost
k1 = frontend_mxu.capture_frontend_mm_pallas
on_card = os.environ.get("RX_PLATFORM", "") != "cpu"
# join the job and reach the card before any step is timed, so the wall
# times leave out the peers' start-up skew and the CUDA context
multihost.init()
if on_card:
    torch.zeros(1, device="cuda")
done = []
for step in json.load(open(sys.argv[2])):
    saved = {k: os.environ.get(k) for k in step["env"]}
    os.environ.update(step["env"])
    app = importlib.import_module("rx_tools_tpu_torch.apps." + step["app"])
    k1.launches = 0
    t = time.perf_counter()
    rc = app.main(step["args"])
    if on_card:
        torch.cuda.synchronize()
    done.append({"name": step["name"], "rc": rc, "k1": k1.launches,
                 "wall_s": time.perf_counter() - t})
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if rc != 0:
        break
print("RANK_RESULT " + json.dumps(done), flush=True)
sys.exit(0 if all(d["rc"] == 0 for d in done) else 1)
"""


def rank_job(tag, plan, n_ranks, tmp, env=(), timeout=400):
    """Run ``plan`` (a list of {name, app, args, env}) in ``n_ranks``
    processes joined over gloo on localhost; returns each rank's results by
    step name.  A rank that fails or outlives ``timeout`` fails the phase,
    and every rank is stopped."""
    import socket
    plan_path = tmp / f"{tag}.json"
    plan_path.write_text(json.dumps(plan))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs, logs = [], []
    for rank in range(n_ranks):
        e = dict(os.environ)
        for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "JAX_NUM_CPU_DEVICES"):
            e.pop(k, None)
        if n_ranks > 1:
            e.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                     JAX_NUM_PROCESSES=str(n_ranks), JAX_PROCESS_ID=str(rank))
        e.update(dict(env))
        out = open(tmp / f"{tag}.{rank}.out", "w+")
        err = open(tmp / f"{tag}.{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, str(ROOT), str(plan_path)],
            stdout=out, stderr=err, env=e))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        text, errs = out.read(), err.read()
        out.close()
        err.close()
        line = [ln for ln in text.splitlines() if ln.startswith("RANK_RESULT")]
        if p.returncode != 0 or not line:
            fail(f"{tag}: rank {rank} exited {p.returncode}:\n{errs[-3000:]}")
        results.append({d["name"]: d for d in json.loads(line[0].split(" ", 1)[1])})
    return results


def parallel_phase(dev, cfg, synth, counted, tmp):
    """Phase 11: parallel/ on one card — time, hop and channel sharding on
    meshes that repeat ``cuda:0``, then the CLIs as two rank processes that
    share the card over gloo.  Returns the K1 launches of the rank
    processes."""
    import numpy as np
    import torch
    from rx_tools_tpu_torch.apps import rx_sdr
    from rx_tools_tpu_torch.kernels.timing import time_ms
    from rx_tools_tpu_torch.models import fmchain, pfb, powerscan
    from rx_tools_tpu_torch.parallel import (channel_sharded_pfb_step,
                                             hop_sharded_sweep, make_mesh,
                                             time_sharded_fm)
    from rx_tools_tpu_torch.parallel.hopshard import int_hop_sharded
    from rx_tools_tpu_torch.parallel.timeshard import resampler_modulus
    from rx_tools_tpu_torch.stream.scan import scan_fm_blocks

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def events_ms(fn, rounds=5):
        """Median time of ``fn()`` between CUDA events, synchronised (the
        sharded call waits on the host once for its carry)."""
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    # (a) time sharding at BASELINE config #1 (D = 14, 258048-sample
    # blocks): 4 shards of 12 blocks on [cuda:0] * 4, warmup 2, a first
    # super-chunk and a continuation, against the unsharded scan of the
    # same blocks (chained 12-block chunks, the runner's chunk) and
    # against the same calls on the CPU
    s_n, m, warmup, block = 4, 12, 2, 258048
    src = synth()
    blocks = np.stack([src.read_stream(block)[1] for _ in range(2 * s_n * m)])
    mesh = make_mesh(devices=[dev] * s_n)
    cmesh = make_mesh(devices=[cpu] * s_n)
    fmod = resampler_modulus(cfg)
    chunks = [blocks[: s_n * m], blocks[s_n * m:]]
    halo = chunks[0][-warmup:]

    def sharded(mesh_, c, carry=None, on=None):
        x = chunks[c].reshape(s_n, m, -1)
        if on is not None:
            x = torch.from_numpy(x).to(on)
        if c == 0:
            return time_sharded_fm(cfg, x, mesh=mesh_, warmup=warmup)
        return time_sharded_fm(cfg, x, mesh=mesh_, warmup=warmup, cont=True,
                               halo0=halo, block_offset_mod=(s_n * m) % fmod,
                               iir_carry=carry)

    (a1, nv1, cr1), k1a = counted(lambda: sharded(mesh, 0))
    (a2, nv2, _), k1b = counted(lambda: sharded(mesh, 1, cr1[-1]))
    k1_shard = [k1a["capture_frontend_mm_pallas"],
                k1b["capture_frontend_mm_pallas"]]
    if k1_shard != [2 * s_n, 2 * s_n]:
        fail(f"time sharding launched K1 {k1_shard} times, want "
             f"{2 * s_n} a call (one a shard, one a halo replay)")
    st = fmchain.init_state(cfg, dev)
    ref_a, ref_nv = [], []
    for i in range(0, blocks.shape[0], m):
        st, a, nv, _ = scan_fm_blocks(cfg, st, blocks[i: i + m])
        ref_a.append(a)
        ref_nv.append(nv)
    ref_a = torch.cat(ref_a).cpu().numpy()
    ref_nv = torch.cat(ref_nv).cpu().numpy()
    got_a = np.concatenate([a1.cpu().numpy().reshape(s_n * m, -1),
                            a2.cpu().numpy().reshape(s_n * m, -1)])
    got_nv = np.concatenate([nv1.cpu().numpy().reshape(-1),
                             nv2.cpu().numpy().reshape(-1)])
    if not np.array_equal(got_nv, ref_nv):
        fail("time sharding: emission counts differ from the unsharded scan")
    flat = np.concatenate([got_a[i, : got_nv[i]] for i in range(len(got_nv))])
    flat_ref = np.concatenate([ref_a[i, : ref_nv[i]]
                               for i in range(len(ref_nv))])
    if not np.allclose(flat, flat_ref, rtol=1e-4, atol=0.1):
        fail("time sharding outside rtol 1e-4 / atol 0.1 of the unsharded "
             f"scan: max |diff| {np.abs(flat - flat_ref).max()}")
    c1 = sharded(cmesh, 0)
    c2 = sharded(cmesh, 1, c1[2][-1])
    cpu_flat = np.concatenate([
        a.numpy().reshape(s_n * m, -1)[i, : n]
        for a, nv in ((c1[0], c1[1]), (c2[0], c2[1]))
        for i, n in enumerate(nv.numpy().reshape(-1))])
    pcm, pcm_cpu = (fmchain.audio_to_int16(x) for x in (flat, cpu_flat))
    if pcm.size != pcm_cpu.size:
        fail(f"time sharding: card {pcm.size} vs CPU {pcm_cpu.size} PCM")
    lsb = int(np.abs(pcm.astype(int) - pcm_cpu.astype(int)).max())
    if lsb > 1:
        fail(f"time sharding: card and CPU PCM differ by {lsb} LSB")
    hz = tone_hz(pcm)
    if abs(hz - 1000.0) > 10:
        fail(f"time sharding: tone not recovered ({hz} Hz)")
    print(f"time sharding (config #1, {s_n} x {m} blocks, warmup {warmup}, "
          f"2 super-chunks): counts equal, max |diff| vs unsharded scan "
          f"{np.abs(flat - flat_ref).max():.4g}, card vs CPU {lsb} LSB, tone "
          f"{hz:.1f} Hz, K1 launches {k1_shard}")
    x0 = torch.from_numpy(chunks[0]).to(dev)

    def unsharded_scan():
        st = fmchain.init_state(cfg, dev)
        for i in range(0, s_n * m, m):
            st, *_ = scan_fm_blocks(cfg, st, x0[i: i + m])

    x0s = x0.reshape(s_n, m, -1)
    walls = {"time_sharded_fm": [], "scan_fm_blocks": []}
    for name in ("scan_fm_blocks", "time_sharded_fm", "time_sharded_fm",
                 "scan_fm_blocks"):
        fn = (unsharded_scan if name == "scan_fm_blocks" else
              lambda: time_sharded_fm(cfg, x0s, mesh=mesh, warmup=warmup))
        walls[name].append(events_ms(fn))
    print(json.dumps({"parallel": "time_sharded_fm vs scan_fm_blocks",
                      "blocks": s_n * m, "shards": s_n, "warmup": warmup,
                      "ms": walls,
                      "gb_per_s_int16_in": {
                          k: [4 * block * s_n * m / (t * 1e-3) / 1e9
                              for t in v] for k, v in walls.items()}}))
    del x0, x0s, blocks, chunks

    # (b) hop sharding at BASELINE config #5's shape (402 hops, 512 bins,
    # 16 segments) on [cuda:0] * 2, both tiers, against the unsharded step
    h, pcfg = 402, powerscan.PowerConfig(bin_e=9, buf_len=2 * 512 * 16)
    gen = torch.Generator(device=dev).manual_seed(8)
    hb = [torch.randint(-20000, 20000, (h, pcfg.buf_len), generator=gen,
                        device=dev, dtype=torch.int32).to(torch.int16)
          for _ in range(3)]
    hmesh = make_mesh(devices=[dev] * 2, axis="h")
    acc_s = acc_u = powerscan.new_sweep_accum(h, pcfg, dev)
    for b in hb:
        acc_s = hop_sharded_sweep(pcfg, acc_s, b, hmesh)
        acc_u = powerscan.sweep_step(pcfg, acc_u, b)
    avg_s, avg_u = acc_s.avg.cpu().numpy(), acc_u.avg.cpu().numpy()
    rel = float((np.abs(avg_s - avg_u) / np.abs(avg_u).clip(1e-30)).max())
    if not (np.allclose(avg_s, avg_u, rtol=1e-6) and torch.equal(
            acc_s.samples, acc_u.samples)):
        fail(f"hop sharding: avg max rel err {rel} (rtol 1e-6) or samples "
             "differ")
    ints = int_hop_sharded(pcfg, hb[0], hmesh)
    if not torch.equal(ints, powerscan.int_sweep_powers(pcfg, hb[0])):
        fail("int_hop_sharded differs from int_sweep_powers on the card")
    hop_ms = {
        "sweep_step": time_ms(lambda b: powerscan.sweep_step(pcfg, acc_u, b),
                              [(b,) for b in hb]),
        "hop_sharded_sweep": time_ms(
            lambda b: hop_sharded_sweep(pcfg, acc_u, b, hmesh),
            [(b,) for b in hb]),
        "int_sweep_powers": time_ms(
            lambda b: powerscan.int_sweep_powers(pcfg, b),
            [(b,) for b in hb], iters=5),
        "int_hop_sharded": time_ms(lambda b: int_hop_sharded(pcfg, b, hmesh),
                                   [(b,) for b in hb], iters=5)}
    print(f"hop sharding (config #5 shape, 2 shards, 3 sweeps): avg max rel "
          f"err {rel:.3g}, samples equal; --int-fft bitwise")
    print(json.dumps({"parallel": "hop sharding, config #5 shape",
                      "hops": h, "shards": 2, "ms": hop_ms}))
    del hb, acc_s, acc_u

    # (c) channel sharding at pfb_step_gbs's geometry (D = 64, 524288-sample
    # blocks) on [cuda:0] * 4, over phase 10's eight-station scene
    scene = tmp / "scene.cs16"
    nb = 524288
    if rx_sdr.main(["-f", str(CH_CENTER), "-s", "2.4M", "-d", CH_SCENE, "-n",
                    str(2 * nb), "-F", "CS16", str(scene)]) != 0:
        fail("rx_sdr could not record the phase 11 scene")
    sblocks = np.fromfile(scene, np.int16).reshape(2, 2 * nb)
    ccfg = pfb.PfbConfig(capture_rate=CAPTURE_RATE, n_channels=64,
                         custom_atan=1, deemph_a=7, rate_out2=AUDIO_RATE)
    stations = [(k + 64) % 64 for k in (-29, -22, -13, -5, 3, 9, 17, 26)]
    cmesh4 = make_mesh(devices=[dev] * 4, axis="c")

    def run_pfb(step, device, *mesh_):
        st = pfb.init_state(ccfg, device)
        out = []
        for b in sblocks:
            st, a, nv = step(ccfg, st, b, *mesh_)
            out.append(fmchain.audio_to_int16(a.cpu().numpy()))
        return np.concatenate(out, axis=1)

    sh = run_pfb(channel_sharded_pfb_step, dev, cmesh4)
    single = run_pfb(pfb.pfb_step, dev)
    sh_cpu = run_pfb(channel_sharded_pfb_step, cpu,
                     make_mesh(devices=[cpu] * 4, axis="c"))
    d_one = np.abs(sh.astype(int) - single.astype(int))
    d_cpu = np.abs(sh.astype(int) - sh_cpu.astype(int))
    if d_one[stations].max() > 1 or d_cpu[stations].max() > 1:
        fail(f"channel sharding: station channels {d_one[stations].max()} "
             f"LSB from pfb_step, {d_cpu[stations].max()} from the CPU")
    cb = [(torch.from_numpy(b).to(dev),) for b in sblocks]
    holder = {}

    def step_timed(kind):
        holder[kind] = pfb.init_state(ccfg, dev)

        def fn(b):
            if kind == "pfb_step":
                holder[kind], a, nv = pfb.pfb_step(ccfg, holder[kind], b)
            else:
                holder[kind], a, nv = channel_sharded_pfb_step(
                    ccfg, holder[kind], b, cmesh4)
            return a
        return fn

    ch_ms = {k: time_ms(step_timed(k), cb, iters=10)
             for k in ("pfb_step", "channel_sharded_pfb_step")}
    print(f"channel sharding (D = 64, {nb}-sample blocks, 4 shards, 2 "
          f"blocks): station channels {d_one[stations].max()} LSB from "
          f"pfb_step and {d_cpu[stations].max()} from the CPU (all 64: "
          f"{d_one.max()} and {d_cpu.max()})")
    print(json.dumps({"parallel": "channel sharding, D = 64", "shards": 4,
                      "block_samples": nb, "ms": ch_ms}))
    del cb, holder

    # (d) the CLIs as rank processes sharing the card over gloo: config #1
    # recorded by rx_sdr (1.2 s at 2.4 Msps), rx_fm -E shard with 64-block
    # shards (two sharded super-chunks and a tail), rx_power config #5 in
    # both tiers, rx_channels -n 64 over the scene
    cap = tmp / "cfg1.cs16"
    tune = STATION + CAPTURE_RATE / 4 + 16e3
    if rx_sdr.main(["-f", f"{tune:.0f}", "-s", "2.4M", "-d",
                    "synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,seed=7,"
                    f"carrier={STATION:.0f}", "-n", "2880000", "-F", "CS16",
                    str(cap)]) != 0:
        fail("rx_sdr could not record config #1 for phase 11")
    fm_src = ["-f", f"{STATION:.0f}", "-s", "2.4M", "-d",
              f"file={cap},format=CS16,rate=2.4M"]
    p5 = ["-f", "100M:1G:10k", "-c", "20%", "-1", "-S", "0", "-d",
          POWER_SCENE]
    shard = {"RX_SHARD_BLOCKS": "64"}

    def plan(layout, one_rank):
        o = tmp / layout
        steps = [
            ("wbfm", "rx_fm", ["-M", "wbfm", "-E", "shard"] + fm_src
             + [f"{o}.wbfm.raw"], shard),
            ("fm", "rx_fm", ["-M", "fm", "-E", "shard"] + fm_src
             + [f"{o}.fm.raw"], shard),
            ("power", "rx_power", p5 + [f"{o}.p.csv"], {}),
            ("power-int", "rx_power", p5 + ["--int-fft", f"{o}.pi.csv"], {}),
            ("channels", "rx_channels", [
                "-f", str(CH_CENTER), "-s", "2.4M", "-n", "64", "-M", "fm",
                "-A", "fast", "-c", "us", "-r", "32k", "-d",
                f"file={scene},format=CS16,rate=2.4M", f"{o}.ch"],
             {"RX_PFB": "cm"} if one_rank else {})]
        if one_rank:
            steps.append(("fm-stream", "rx_fm", ["-M", "fm"] + fm_src
                          + [f"{o}.fms.raw"], {}))
        return [dict(name=n, app=a, args=g, env=e) for n, a, g, e in steps]

    two = rank_job("two", plan("two", False), 2, tmp)
    one = rank_job("one", plan("one", True), 1, tmp)
    two_cpu = rank_job("two_cpu", plan("two_cpu", False)[:1], 2, tmp,
                       env=[("RX_PLATFORM", "cpu")])
    if "Sharding super-chunks of 128 blocks over 2 devices" not in (
            tmp / "two.0.err").read_text():
        fail("the 2-rank rx_fm -E shard did not shard a super-chunk")

    def pcm(name):
        return np.fromfile(tmp / name, np.int16)

    w2, w2c, w1 = pcm("two.wbfm.raw"), pcm("two_cpu.wbfm.raw"), pcm(
        "one.wbfm.raw")
    if w2.size != w2c.size or w2.size != w1.size or w2.size < 20000:
        fail(f"rx_fm -E shard wbfm: 2 ranks {w2.size}, on the CPU "
             f"{w2c.size}, 1 rank {w1.size} PCM samples")
    lsb_cpu = int(np.abs(w2.astype(int) - w2c.astype(int)).max())
    lsb_one = int(np.abs(w2.astype(int) - w1.astype(int)).max())
    hz = tone_hz(w2)
    if lsb_cpu > 1 or abs(hz - 1000.0) > 10:
        fail(f"rx_fm -E shard wbfm, 2 ranks: {lsb_cpu} LSB from the CPU, "
             f"tone {hz} Hz")
    f2, f1 = (tmp / "two.fm.raw").read_bytes(), (
        tmp / "one.fms.raw").read_bytes()
    if f2 != f1 or len(f1) < 40000:
        fail(f"rx_fm -M fm -E shard at 2 ranks ({len(f2)} bytes) differs "
             f"from the streaming run ({len(f1)} bytes)")
    pw = {}
    for name, exact in (("p", False), ("pi", True)):
        rows2, rows1 = csv_rows(tmp / f"two.{name}.csv"), csv_rows(
            tmp / f"one.{name}.csv")
        if len(rows1) != 402:
            fail(f"rx_power {name}: {len(rows1)} rows, want 402")
        pw[name] = (rows_agree(f"rx_power {name} 2 ranks vs 1", rows2, rows1,
                               exact), rows2 == rows1)
    ch2 = {p.name: np.fromfile(p, np.int16)
           for p in sorted((tmp / "two.ch").glob("ch*.s16"))}
    ch1 = {p.name: np.fromfile(p, np.int16)
           for p in sorted((tmp / "one.ch").glob("ch*.s16"))}
    if list(ch2) != list(ch1) or len(ch1) != 64:
        fail(f"rx_channels 2 ranks wrote {len(ch2)} files, 1 rank {len(ch1)}")
    ch_lsb = {}
    for k, (n2, a) in enumerate(ch2.items()):
        b = ch1[n2]
        if a.size != b.size or a.size < 4000:
            fail(f"rx_channels {n2}: 2 ranks {a.size}, 1 rank {b.size}")
        ch_lsb[k] = int(np.abs(a.astype(int) - b.astype(int)).max())
    st_lsb = max(ch_lsb[k] for k in stations)
    if st_lsb > 2:
        fail(f"rx_channels 2 ranks vs 1: station channels {st_lsb} LSB")
    print(f"CLIs at 2 ranks on one card: rx_fm wbfm -E shard {w2.size} PCM, "
          f"{lsb_cpu} LSB from 2 CPU ranks, {lsb_one} from 1 rank, tone "
          f"{hz:.1f} Hz; -M fm -E shard = streaming bytes; rx_power config "
          f"#5 float max |dB| {pw['p'][0]} (identical {pw['p'][1]}), "
          f"--int-fft identical {pw['pi'][1]}; rx_channels -n 64 station "
          f"channels {st_lsb} LSB (all: {max(ch_lsb.values())})")
    print(json.dumps({"parallel": "CLI wall s, 2 ranks vs 1 on one card",
                      "two_ranks": {k: [r[k]["wall_s"] for r in two]
                                    for k in two[0]},
                      "one_rank": {k: v["wall_s"] for k, v in one[0].items()},
                      "two_cpu_ranks": {k: [r[k]["wall_s"] for r in two_cpu]
                                        for k in two_cpu[0]},
                      "k1_launches": {k: [r[k]["k1"] for r in two]
                                      for k in two[0]}}))

    # (e) entry.dryrun_multichip(4), the twin of __graft_entry__.py's dry
    # run, on [cuda:0] * 4; then its outputs against the same run on the
    # CPU: counts and shapes exact, FM audio and carries at the time
    # shards' rtol 1e-4 / atol 0.1, the PFB at tests/test_pfb.py:174-176's
    # bound (scaled by each channel's peak), the sweep's samples exact and
    # its avg within 1e-6 of each hop row's peak: cuFFT and the CPU's FFT
    # round apart by ~1e-7 of a row's energy, so a bin far below its row's
    # peak differs by more than 1e-6 of itself (the elementwise relative
    # error is printed beside it)
    from rx_tools_tpu_torch import entry
    t = time.perf_counter()
    _, k_dry = counted(lambda: entry.dryrun_multichip(4))
    dry_wall = time.perf_counter() - t
    dry, _ = counted(lambda: entry._dryrun_outputs(4, "cuda"))
    dry_cpu = entry._dryrun_outputs(4, "cpu")
    dry_err, bad = {}, []
    for name, outs in dry.items():
        got = [x.cpu().numpy() for x in outs]
        want = [x.numpy() for x in dry_cpu[name]]
        if [g.shape for g in got] != [w.shape for w in want]:
            fail(f"dryrun {name}: card shapes {[g.shape for g in got]}, "
                 f"CPU {[w.shape for w in want]}")
        if name == "sweep":
            (a, n), (ca, cn) = got, want
            peak = np.abs(ca).max(axis=1, keepdims=True)
            err = float((np.abs(a - ca) / peak).max())
            dry_err["sweep_elementwise_rel"] = float(
                (np.abs(a - ca) / np.abs(ca)).max())
            ok = err <= 1e-6 and np.array_equal(n, cn)
        elif name == "pfb":
            (a, nv), (ca, cnv) = got, want
            ok, err = np.array_equal(nv, cnv), 0.0
            for ch in range(a.shape[0]):
                k = int(cnv[ch])
                scale = max(1.0, float(np.abs(ca[ch, :k]).max(initial=0)))
                ok &= np.allclose(a[ch, :k] / scale, ca[ch, :k] / scale,
                                  rtol=2e-4, atol=2e-4)
                err = max(err, float(np.abs(a[ch, :k] - ca[ch, :k]).max(
                    initial=0)) / scale)
        else:
            (a, nv, c), (ca, cnv, cc) = got, want
            ok = np.array_equal(nv, cnv) and np.allclose(c, cc, rtol=1e-4,
                                                         atol=0.1)
            err = 0.0
            for idx in np.ndindex(*nv.shape):
                k = int(cnv[idx])
                ok &= np.allclose(a[idx][:k], ca[idx][:k], rtol=1e-4,
                                  atol=0.1)
                err = max(err, float(np.abs(a[idx][:k] - ca[idx][:k]).max(
                    initial=0)))
        dry_err[name] = err
        if not ok:
            bad.append(name)
    print(json.dumps({"dryrun_multichip": 4, "mesh": "[cuda:0] * 4",
                      "shapes": {k: [list(x.shape) for x in v]
                                 for k, v in dry.items()},
                      "k1_launches": k_dry["capture_frontend_mm_pallas"],
                      "wall_s": dry_wall, "err_vs_cpu": dry_err,
                      "card": card_line()}))
    if bad or k_dry["capture_frontend_mm_pallas"] <= 0:
        fail(f"dryrun_multichip(4): {bad} outside their class against the "
             f"CPU, K1 launches {k_dry}")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return sum(d["k1"] for r in two + one for d in r.values())


def soak_phase(cu8, tmp):
    """Phase 12: the hardware-soak twin, ``python -m
    rx_tools_tpu_torch.hw_soak``, as its user runs it: with no radio it
    exits 2; against an rtl_tcp server on localhost that serves phase 9's
    config #1 CU8 recording (repeated to 1.25 s) to each of its two
    clients, with the band narrowed to the recording's span, its CLIs run
    on the card and it exits 0."""
    t_phase = time.perf_counter()

    def soak(*args):
        """Start the soak; ``finish()`` gives (exit code, its lines)."""
        p = subprocess.Popen([sys.executable, "-m",
                              "rx_tools_tpu_torch.hw_soak", *args], cwd=ROOT,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)

        def finish():
            try:
                _, err = p.communicate(timeout=400)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                fail(f"hw_soak {' '.join(args)} did not finish in 400 s")
            return p.returncode, [line for line in err.splitlines()
                                  if line.startswith("[hw_soak]")]
        return finish

    # the run with no radio and the run against the mock at once: each
    # spends most of its time starting Python processes
    no_radio = soak()
    mock = RtlTcpMock(cu8 * 5, connections=2)
    t = time.perf_counter()
    rc, lines = soak("--rtltcp", f"127.0.0.1:{mock.port}", "--fm-freq",
                     f"{STATION:.0f}", "--band", "99.8M:102M:10k",
                     "--seconds", "300")()
    wall = time.perf_counter() - t
    mock.join()
    rc2, lines2 = no_radio()
    if rc2 != 2:
        fail(f"hw_soak with no radio exited {rc2}, want 2: {lines2}")
    print(f"hw_soak, no radio: exit {rc2} ({lines2[-1]})")
    for line in lines:
        print(f"  {line}")
    if rc != 0:
        fail(f"hw_soak against the rtl_tcp mock exited {rc}, want 0")
    print(json.dumps({"hw_soak": "rtl_tcp mock, phase 9's config #1 CU8 "
                      "x5, band 99.8M:102M:10k", "exit": rc,
                      "wall_s": wall, "card": card_line()}))
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


WBFM_SYNTH = ("synth=fm,audio=1k,dev=50k,amp=0.8,noise=0.001,seed=3,"
              "carrier=100.3M")
WBFM_BLOCKS = 64


def int_audio_deemph_calls(dev):
    """The ``int_deemph`` calls of ``rx_fm -f 100.3M -M wbfm -d WBFM_SYNTH
    --blocks 64 --int-audio`` as ``(avg, x, a)`` on ``dev``, and the PCM
    the chain emits: ``models/fmint.py`` stepped block by block (demod and
    seam patch, then the audio post), set up as the CLI sets up the wbfm
    preset.  Phase 7 holds this PCM to the CLI's bytes, so these calls are
    the CLI's."""
    import numpy as np
    from rx_tools_tpu_torch import ops
    from rx_tools_tpu_torch.apps import rx_fm
    from rx_tools_tpu_torch.iq.sources import make_source
    from rx_tools_tpu_torch.models import fmchain, fmint
    from rx_tools_tpu_torch.stream.scan import stack_blocks

    rate = 170_000                       # -M wbfm: -s 170k -A fast -r 32k
    cfg, freq, capture_rate = fmchain.plan_capture(fmchain.FmConfig(
        rate_in=rate, rate_out=rate, rate_out2=AUDIO_RATE, downsample=1,
        custom_atan=ops.DISC_FAST, deemph_a=ops.deemph_alpha(rate, 75)),
        STATION + 16_000)                # the preset's tuning offset
    if cfg.post_downsample != 1:         # else x is the low-passed result
        fail(f"wbfm planned post_downsample {cfg.post_downsample}, not 1")
    src = make_source(WBFM_SYNTH)
    src.set_sample_rate(capture_rate)
    src.set_frequency(freq)
    src.activate()
    bs = fmchain.block_samples(cfg)
    st, calls, pcm = fmint.init_state(dev), [], []
    for iq in rx_fm._iter_pieces(src, 8 * 2 * bs):
        for block in stack_blocks(iq, bs)[:WBFM_BLOCKS - len(calls)]:
            st, x = fmint.demod_block(cfg, st, block)
            calls.append((st.deemph_avg.clone(), x.clone(), cfg.deemph_a))
            st, audio, n = fmint._post(cfg, st, x)
            pcm.append(audio[:int(n)].cpu().numpy().astype(np.int16))
        if len(calls) == WBFM_BLOCKS:
            break
    src.close()
    if len(calls) != WBFM_BLOCKS:
        fail(f"the wbfm synth gave {len(calls)} blocks, not {WBFM_BLOCKS}")
    return calls, np.concatenate(pcm)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "rx_tools_tpu_torch" / "kernels" / "csrc").is_dir():
        fail(f"no rx_tools_tpu_torch checkout beside {__file__}")
    sys.path.insert(0, str(ROOT))

    from rx_tools_tpu_torch import ops
    from rx_tools_tpu_torch.apps import rx_fm
    from rx_tools_tpu_torch.iq.sources import make_source
    from rx_tools_tpu_torch import kernels
    from rx_tools_tpu_torch.kernels import build, plan
    from rx_tools_tpu_torch.kernels.timing import time_ms
    from rx_tools_tpu_torch.models import fmchain
    from rx_tools_tpu_torch.ops import frontend_mxu, fused_frontend
    from rx_tools_tpu_torch.ops import intaudio, pallas_frontend
    from rx_tools_tpu_torch.stream import checkpoint
    from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner
    from rx_tools_tpu_torch.stream.scan import scan_fm_blocks

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- phase 1: card, toolkit, build ---------------------------------
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s (nvcc per source, in parallel)")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    k1 = frontend_mxu.capture_frontend_mm_pallas
    k4 = frontend_mxu.capture_frontend_mm_pallas2
    k3 = pallas_frontend.capture_frontend_pallas
    k2 = fused_frontend.fused_capture_fm
    counters = {"capture_frontend_mm_pallas": k1,
                "capture_frontend_pallas": k3,
                "capture_frontend_mm_pallas2": k4,
                "fused_capture_fm": k2,
                "int_deemph": intaudio.deemph_int}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    # ---- phase 2: kernels against their plain versions ------------------
    geoms = {"cli": (6, 8208, 16), "config1": (14, 258048, 12)}
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}
    for geom, (d, n, m) in geoms.items():
        x = torch.randint(-32768, 32767, (m * 2 * n,), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.int16)
        kpb = n // d
        plain_i, plain_q = frontend_mxu.capture_head_plain(x, d)
        plain_il = frontend_mxu.capture_head_plain(x, d, interleaved=True)
        for name, got in (("K1", k1(x, d)), ("K4", k4(x, d))):
            if not (torch.equal(got[0], plain_i)
                    and torch.equal(got[1], plain_q)):
                fail(f"{name} differs from its plain version at {geom}")
        if not torch.equal(k3(x, d), plain_il):
            fail(f"K3 differs from its plain version at {geom}")
        prev = torch.tensor([3.0, -2.0], device=dev)
        pg, dg, lg = fused_frontend.fused_capture_fm_demod(prev, x, d, kpb)
        pp, dp, lp = fused_frontend.fused_capture_fm_plain(prev, x, d, kpb)
        torch.cuda.synchronize()
        d_err = float((dg - dp).abs().max())
        d_ulps = ulp_distance(dg.cpu().numpy(), dp.cpu().numpy())
        lv_ok = torch.allclose(lg, lp, rtol=1e-5, atol=1e-3)
        if d_err > 5e-2 or not lv_ok or float((pg - pp).abs().max()) > 1e-3:
            fail(f"K2 outside its tolerance at {geom}: d {d_err}, "
                 f"levels ok {lv_ok}")
        print(f"{geom}: K1/K3/K4 bitwise; K2 d max |err| {d_err} "
              f"({d_ulps} ulp), levels max rel err "
              f"{float(((lg - lp).abs() / lp.abs()).max()):.3g}")
        report[geom] = dict(x=x, d=d, kpb=kpb, d_err=d_err, d_ulps=d_ulps)

    # edge cases of the tiled kernels at config #1: views 4, 8 and 12
    # bytes past a 16-byte boundary (the kernels bulk-copy each tile's
    # 16-byte superset), one block (the per-block path), launches of
    # different block counts in a row (the fused kernel's ticket counter
    # must be back at zero) and two forced grid sizes (same levels)
    d, kpb, x = 14, 18432, report["config1"]["x"]
    prev = torch.tensor([3.0, -2.0], device=dev)
    for off in (2, 4, 6):
        xo = x[off:off + 2 * d * kpb * 11]
        zi, zq = frontend_mxu.capture_head_plain(xo, d)
        g1, g4 = k1(xo, d), k4(xo, d)
        if not (torch.equal(g1[0], zi) and torch.equal(g1[1], zq)
                and torch.equal(g4[0], zi) and torch.equal(g4[1], zq)
                and torch.equal(k3(xo, d), torch.stack([zi, zq], dim=-1))):
            fail(f"the head differs from its plain version {2 * off} bytes "
                 "off 16-byte alignment")
        dg, lg, _ = k2(prev, xo, d, kpb)
        _, dp, lp = fused_frontend.fused_capture_fm_plain(prev, xo, d, kpb)
        if not (torch.equal(dg, dp)
                and torch.allclose(lg, lp, rtol=1e-5, atol=1e-3)):
            fail(f"K2 differs from its plain version {2 * off} bytes off "
                 "16-byte alignment")
    one = x[:2 * d * kpb]
    d1, l1, _ = k2(prev, one, d, kpb)
    _, dp1, lp1 = fused_frontend.fused_capture_fm_plain(prev, one, d, kpb)
    if not (torch.equal(d1, dp1)
            and torch.allclose(l1, lp1, rtol=1e-5, atol=1e-3)):
        fail("K2 differs from its plain version on one block")
    _, l12a, _ = k2(prev, x, d, kpb)
    _, l1b, _ = k2(prev, one, d, kpb)
    _, l12b, _ = k2(prev, x, d, kpb, grid=7)
    if not (torch.equal(l12a, l12b) and torch.equal(l1b, l1)
            and torch.equal(l1, l12a[:1])):
        fail("K2's levels change between launches or grid sizes")
    print("edge cases: offset views (4, 8, 12 B) bitwise, one block, "
          "ticket reset across m = 12, 1, 12 and grid sizes: levels bitwise")

    # timing at the main path's shapes (config #1 chunk)
    cfg1 = report["config1"]
    d, kpb = cfg1["d"], cfg1["kpb"]
    x0 = cfg1["x"]
    n_in = x0.numel() // 2                       # complex samples
    k_out = n_in // d
    bufs = [(x0 if i == 0 else torch.randint(
        -32768, 32767, x0.shape, generator=gen, device=dev,
        dtype=torch.int32).to(torch.int16), d) for i in range(5)]
    prev = torch.zeros(2, device=dev)
    fbufs = [(prev, b, d, kpb) for b, _ in bufs]
    m_blocks = k_out // kpb
    kern = {
        "capture_frontend_mm_pallas": dict(
            fn=k1, plain=lambda xx, dd: frontend_mxu.capture_head_plain(
                xx, dd), args=bufs, out_bytes=8 * k_out, err=0.0,
            source="rx_tools_tpu_torch/kernels/csrc/capture_head.cu",
            replaces="rx_tools_tpu/ops/frontend_mxu.py:262"),
        "capture_frontend_pallas": dict(
            fn=k3, plain=lambda xx, dd: frontend_mxu.capture_head_plain(
                xx, dd, interleaved=True), args=bufs, out_bytes=8 * k_out,
            err=0.0,
            source="rx_tools_tpu_torch/kernels/csrc/capture_head.cu",
            replaces="rx_tools_tpu/ops/pallas_frontend.py:105"),
        "capture_frontend_mm_pallas2": dict(
            fn=k4, plain=lambda xx, dd: frontend_mxu.capture_head_plain(
                xx, dd), args=bufs, out_bytes=8 * k_out, err=0.0,
            source="rx_tools_tpu_torch/kernels/csrc/capture_head.cu",
            replaces="rx_tools_tpu/ops/frontend_mxu.py:317"),
        "fused_capture_fm": dict(
            fn=fused_frontend.fused_capture_fm_demod,
            plain=fused_frontend.fused_capture_fm_plain, args=fbufs,
            out_bytes=4 * k_out + 4 * m_blocks + 8, err=cfg1["d_err"],
            ops=20 * k_out,
            source="rx_tools_tpu_torch/kernels/csrc/fused_capture_fm.cu",
            replaces="rx_tools_tpu/ops/fused_frontend.py:149"),
    }
    # the head's matrix forms (the reference's plain products, library
    # calls on the card), each held to its class and timed; K1/K3/K4's
    # library time is the fastest bitwise-exact form's
    library_form, library_ms = head_forms(frontend_mxu, bufs, d, card)
    for name in ("capture_frontend_mm_pallas", "capture_frontend_pallas",
                 "capture_frontend_mm_pallas2"):
        kern[name]["library_ms"] = library_ms
        kern[name]["library_form"] = library_form
    for name, k in kern.items():
        k["ms"] = time_ms(k["fn"], k["args"])
        k["plain_ms"] = time_ms(k["plain"], k["args"], iters=5)
        k["bound_ms"], k["bound_by"] = bound(
            4 * n_in + k["out_bytes"], 2 * n_in + k.get("ops", k_out))
        print(json.dumps({"kernel": name, "shape": f"{m_blocks} x {kpb * d}"
                          f" samples, D={d}", "ms": k["ms"],
                          "bound_ms": k["bound_ms"],
                          "plain_ms": k["plain_ms"],
                          "library_ms": k.get("library_ms"),
                          "library_form": k.get("library_form")}))
    # what K2's persistent runs are worth at config #1: its planned wave
    # (CTAs of one or two tiles) against one CTA a tile, alternated
    tiles = m_blocks * plan.fused_tiles_per_block(
        plan.plan("fused_capture_fm", d), kpb)
    wave = kernels.grid(plan.plan("fused_capture_fm", d), tiles, dev)
    grid_ms = {}
    for g in (wave, tiles, wave, tiles):
        grid_ms.setdefault(f"grid {g}", []).append(
            time_ms(lambda *a, g=g: k2(*a, grid=g), fbufs))
    print(json.dumps({"kernel": "fused_capture_fm", "tiles": tiles,
                      "planned_grid": wave, "ms_by_grid": grid_ms}))
    del bufs, fbufs, report

    # size sweep: K1 and K2 at 1, 12 and 48 blocks of config #1, inputs
    # rotated through more than twice the L2; ms = a + b * bytes fitted
    # by least squares gives the fixed cost a and the streaming rate 1/b
    block_n = kpb * d
    for name, fn, out_per_k in (
            ("capture_frontend_mm_pallas", lambda xx: k1(xx, d), 8),
            ("fused_capture_fm", lambda xx: fused_frontend.fused_capture_fm(
                prev, xx, d, kpb), 4)):
        pts = []
        for mb in (1, 12, 48):
            n_bytes = mb * block_n * 4 + mb * kpb * out_per_k
            sw = [(torch.randint(-32768, 32767, (mb * 2 * block_n,),
                                 generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int16),)
                  for _ in range(max(3, -(-120_000_000 // n_bytes)))]
            pts.append((n_bytes, time_ms(fn, sw, iters=max(20, len(sw)))))
            del sw
        xs = np.array([p[0] for p in pts], float)
        ys = np.array([p[1] for p in pts], float)
        b, a = np.polyfit(xs, ys, 1)
        print(json.dumps({"sweep": name, "blocks": [1, 12, 48],
                          "bytes": [int(v) for v in xs],
                          "ms": [float(v) for v in ys],
                          "fixed_us": float(a * 1e3),
                          "tb_per_s": float(1e-9 / b)}))

    # ---- phase 3: the main path at config #1 ----------------------------
    rate_in = CAPTURE_RATE // 14
    cfg = fmchain.FmConfig(
        mode="fm", rate_in=rate_in, rate_out=rate_in, rate_out2=AUDIO_RATE,
        downsample=14, custom_atan=ops.DISC_FAST,
        deemph_a=ops.deemph_alpha(rate_in, 75), squelch_level=0.0)
    block, chunk, n_chunks = 258048, 12, 8
    query = ("synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,seed=7,"
             f"carrier={STATION:.0f}")

    def synth():
        src = make_source(query)
        src.set_sample_rate(CAPTURE_RATE)
        src.set_frequency(STATION + CAPTURE_RATE / 4)
        return src

    def run(device, engine=None, fused=None):
        got = []
        runner = ChunkedFmRunner(cfg, synth(),
                                 lambda a, lvl: got.append(a.copy()),
                                 chunk=chunk, block_size=block,
                                 engine=engine, fused=fused, device=device)
        runner.warmup()
        reset_counts()
        t = time.perf_counter()
        stats = runner.run(max_blocks=chunk * n_chunks)
        if device == dev:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {k: f.launches for k, f in counters.items()}
        return np.concatenate(got), stats, wall, counts

    audio_gpu, stats, wall, main_counts = run(dev)
    pcm_gpu = fmchain.audio_to_int16(audio_gpu)
    hz = tone_hz(pcm_gpu)
    print(f"main path: {stats.blocks} blocks, {stats.samples_in} samples in, "
          f"{pcm_gpu.size} PCM out, {wall:.3f} s wall on the card "
          f"({stats.realtime_multiple(CAPTURE_RATE):.1f}x realtime, host "
          f"synth included), tone {hz:.1f} Hz, launches {main_counts}")
    if main_counts["capture_frontend_mm_pallas"] <= 0:
        fail("the main path did not launch the capture-head kernel")
    if abs(hz - 1000.0) > 10:
        fail(f"tone not recovered on the card ({hz} Hz)")
    audio_cpu, _, cpu_wall, _ = run(torch.device("cpu"))
    pcm_cpu = fmchain.audio_to_int16(audio_cpu)
    if pcm_cpu.size != pcm_gpu.size:
        fail(f"card {pcm_gpu.size} vs CPU {pcm_cpu.size} PCM samples")
    lsb = int(np.abs(pcm_gpu.astype(int) - pcm_cpu.astype(int)).max())
    print(f"card vs CPU ({cpu_wall:.1f} s): same count, max |diff| {lsb} LSB")
    if lsb > 1:
        fail(f"card and CPU PCM differ by {lsb} LSB")

    # scan engine vs per-block stepping on the card (first chunk)
    src = synth()
    blocks = np.stack([src.read_stream(block)[1] for _ in range(chunk)])
    st0 = fmchain.init_state(cfg, dev)
    _, a_s, nv_s, _ = scan_fm_blocks(cfg, st0, blocks)
    st, outs = st0, []
    for b in blocks:
        st, a, nv, _ = fmchain.fm_chain_step(cfg, st, b)
        outs.append(a[: int(nv)].cpu().numpy())
    scan_audio = np.concatenate([a_s[i, : int(nv_s[i])].cpu().numpy()
                                 for i in range(chunk)])
    step_audio = np.concatenate(outs)
    bitwise = bool(np.array_equal(scan_audio, step_audio))
    step_lsb = int(np.abs(fmchain.audio_to_int16(scan_audio).astype(int)
                          - fmchain.audio_to_int16(step_audio)).max())
    print(f"scan engine vs per-block stepping on the card: bitwise "
          f"{bitwise}, max |diff| {step_lsb} LSB")
    if step_lsb > 1:
        fail("scan engine and per-block stepping differ by more than 1 LSB")

    # ---- phase 4: the fused path (flat engine, K2) -----------------------
    audio_fused, fstats, fwall, fused_counts = run(dev, engine="flat",
                                                   fused=True)
    print(f"fused path: {fwall:.3f} s wall, launches {fused_counts}")
    if fused_counts["fused_capture_fm"] <= 0:
        fail("the fused path did not launch the fused kernel")
    if audio_fused.size != audio_gpu.size:
        fail(f"fused path {audio_fused.size} vs {audio_gpu.size} samples")
    if not np.allclose(audio_fused, audio_gpu, rtol=1e-4, atol=0.02):
        fail("fused path outside the flat engine's tolerance: max |diff| "
             f"{np.abs(audio_fused - audio_gpu).max()}")
    print(f"fused path vs scan path: max |diff| "
          f"{float(np.abs(audio_fused - audio_gpu).max()):.3g}")

    # ---- phase 5: the CLI ------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "wbfm.raw"
        reset_counts()
        rc = rx_fm.main(["-f", "100.3M", "-M", "wbfm", "-d",
                         "synth=fm,audio=1k,dev=50k,amp=0.8,noise=0.001,"
                         "carrier=100.3M", "--blocks", "64", str(out)])
        cli_counts = {k: f.launches for k, f in counters.items()}
        pcm = np.fromfile(out, np.int16)
    hz = tone_hz(pcm)
    print(f"CLI: rc {rc}, {pcm.size} PCM samples, tone {hz:.1f} Hz, "
          f"launches {cli_counts}")
    if rc != 0 or cli_counts["capture_frontend_mm_pallas"] <= 0:
        fail("the CLI did not run through the capture-head kernel")
    if abs(hz - 1000.0) > 10:
        fail(f"tone not recovered by the CLI ({hz} Hz)")

    # ---- phase 6: int_deemph against its plain version --------------------
    kpb_int = 8208 // 6                  # the wbfm block after the boxcar

    def deemph_class(what, cases):
        """Each call bit for bit against the host walk, the segments the
        ordered fallback walked, and the CUDA-event time over the calls."""
        fb_sum = [0, 0]
        for a, x, da in cases:
            fb = torch.zeros(2, dtype=torch.int32, device=dev)
            p = plan.deemph_plan(x.numel(), da)
            ga, gy = intaudio._launch_deemph(a, x, da, p.seg_len, p.halo, fb)
            pa, py = intaudio.deemph_int_plain(a.cpu(), x.cpu(), da)
            torch.cuda.synchronize()
            if int(ga) != int(pa) or not torch.equal(gy.cpu(), py):
                fail(f"int_deemph differs from its plain version on {what} "
                     f"(n {x.numel()}, a {da}, avg {int(a)})")
            fb_sum = [fb_sum[0] + int(fb[0]), fb_sum[1] + int(fb[1])]
        n, da = cases[0][1].numel(), cases[0][2]
        p = plan.deemph_plan(n, da)
        ms = time_ms(intaudio.deemph_int, cases)
        print(json.dumps({"kernel": "int_deemph", "inputs": what,
                          "calls": len(cases), "n": n, "a": da,
                          "plan": {"S": p.segments(min(n, plan.DEEMPH_TILE)),
                                   "L": p.seg_len, "W": p.halo},
                          "fallback_segments": fb_sum[0],
                          "fallback_samples": fb_sum[1], "ms": ms,
                          "bitwise": True}))
        return ms

    # uniform noise at a = 13 first, the inputs the kernels line's time has
    # always had (averages in +-40000); then the real --int-audio blocks,
    # silence, a = 75, a = 2, the 64-bit walk and one sample
    rng = np.random.default_rng(11)

    def on_card(a0):
        return torch.tensor(int(a0), dtype=torch.int64, device=dev)

    dargs = [(on_card(a0), torch.as_tensor(rng.integers(-32768, 32767,
                                                        kpb_int), device=dev),
              13) for a0 in rng.integers(-40000, 40000, 8)]
    int_calls, int_pcm = int_audio_deemph_calls(dev)
    silence = torch.zeros(kpb_int, dtype=torch.int64, device=dev)
    classes = {
        "uniform noise": dargs,
        "--int-audio wbfm blocks": int_calls,
        "silence": [(a, silence, 13) for a, _, _ in dargs],
        "uniform noise, a = 75": [(a, x, 75) for a, x, _ in dargs],
        "uniform noise, a = 2": [(a, x, 2) for a, x, _ in dargs],
        "the 64-bit walk (avg -(2**31 + 5) - k)": [
            (on_card(-(2 ** 31 + 5) - k), x, 13)
            for k, (_, x, _) in enumerate(dargs)],
    }
    class_ms = {what: deemph_class(what, cases)
                for what, cases in classes.items()}
    deemph_class("one sample", [(dargs[0][0], dargs[0][1][:1], 8)])
    host = [(a.cpu(), x.cpu(), da) for a, x, da in dargs]
    t = time.perf_counter()
    for a, x, da in host:
        intaudio.deemph_int_plain(a, x, da)
    # the plain version is a walk on the host: its wall time, read before
    # anything else runs (the kernel's timing, with its device sleeps,
    # stays outside this interval)
    plain_ms = (time.perf_counter() - t) * 1e3 / len(dargs)
    deemph = dict(
        fn=intaudio.deemph_int, err=0.0, ms=class_ms["uniform noise"],
        plain_ms=plain_ms,
        source="rx_tools_tpu_torch/kernels/csrc/int_deemph.cu",
        replaces="none (port-only; rx_tools_tpu/ops/intaudio.py:158 "
                 "deemph_int is a lax.scan)")
    deemph["bound_ms"], deemph["bound_by"] = bound(16 * kpb_int + 16,
                                                   6 * kpb_int)
    print(json.dumps({"kernel": "int_deemph", "shape": f"{kpb_int} int64",
                      "ms": deemph["ms"], "bound_ms": deemph["bound_ms"],
                      "plain_ms": deemph["plain_ms"],
                      "bitwise": True}))

    # ---- phase 7: the CLI paths of the rest of rx_fm ---------------------
    # launches on every path, each counted from 0 just before it ran
    path_counts = {name: [main_counts[name], fused_counts[name],
                          cli_counts[name]] for name in counters}

    walls = {}                           # the last wall s, card and CPU

    def cli(args, out, cpu=False):
        """``rx_fm`` on the card (or the CPU): (pcm, launches)."""
        with env_var("RX_PLATFORM", "cpu" if cpu else None):
            reset_counts()
            t = time.perf_counter()
            rc = rx_fm.main(args + [str(out)])
            walls[cpu] = time.perf_counter() - t
            counts = {k: f.launches for k, f in counters.items()}
        if rc != 0:
            fail(f"rx_fm {' '.join(args)} exited {rc}")
        if not cpu:
            for k, v in counts.items():
                path_counts[k].append(v)
        return np.fromfile(out, np.int16), counts

    def card_vs_cpu(what, args, tmp, exact=False):
        gpu, counts = cli(args, Path(tmp) / "gpu.raw")
        cpu, _ = cli(args, Path(tmp) / "cpu.raw", cpu=True)
        if gpu.size != cpu.size or gpu.size == 0:
            fail(f"{what}: card {gpu.size} vs CPU {cpu.size} PCM samples")
        diff = int(np.abs(gpu.astype(int) - cpu.astype(int)).max())
        if diff > (0 if exact else 1):
            fail(f"{what}: card and CPU PCM differ by {diff} LSB")
        print(f"{what}: {gpu.size} PCM samples, card vs CPU max |diff| "
              f"{diff} LSB, launches {counts}, wall s card "
              f"{walls[False]:.3f}, CPU {walls[True]:.3f}")
        return gpu, counts

    with tempfile.TemporaryDirectory() as tmp:
        # BASELINE config #2: NBFM, squelch, fifth-order cascade + droop,
        # rational resampler to 48k (stateful head: plain torch ops)
        pcm, _ = card_vs_cpu("config #2 (nbfm -s 96k -r 48k -F 9 -l 10)", [
            "-f", "100M", "-M", "nbfm", "-s", "96k", "-r", "48k", "-F", "9",
            "-l", "10", "-d", "synth=fm,audio=800,dev=5k,amp=0.8,"
            "noise=0.001,seed=5,carrier=100M", "--blocks", "64"], tmp)
        hz = tone_hz(pcm, 48000, 4000)
        if abs(hz - 800.0) > 10:
            fail(f"config #2: tone not recovered ({hz} Hz)")
        print(f"  config #2 tone {hz:.1f} Hz")

        # BASELINE config #3: AM, audio DC block, offset tuning (K1 with
        # rotate=False), then with the raw DC block (-E rdc)
        rotations = []
        launch_head = frontend_mxu._launch_head

        def recording(block, d, rotate, *a, **kw):
            rotations.append(bool(rotate))
            return launch_head(block, d, rotate, *a, **kw)

        # the station 2 kHz off the tuned frequency: the envelope does not
        # care, and -E rdc then removes the tuner's DC, not the carrier
        am = ["-f", "100M", "-M", "am", "-s", "24k", "-E", "dc", "-E",
              "offset", "-d", "synth=am,audio=600,amp=0.5,noise=0.001,"
              "seed=6,carrier=100.002M", "--blocks", "64"]
        with patched(frontend_mxu, "_launch_head", recording):
            pcm, counts = card_vs_cpu("config #3 (am -s 24k -E dc -E offset)",
                                      am, tmp)
        if counts["capture_frontend_mm_pallas"] <= 0 or not rotations \
                or any(rotations):
            fail(f"config #3 did not launch K1 with rotate=False "
                 f"({counts}, rotate flags {set(rotations)})")
        print(f"  config #3: {len(rotations)} K1 launches, all with "
              "rotate=False")
        for what, p in (("config #3", pcm), ("config #3 -E rdc", card_vs_cpu(
                "config #3 -E rdc", am + ["-E", "rdc"], tmp)[0])):
            hz = tone_hz(p, 24000, 2000)
            if abs(hz - 600.0) > 10:
                fail(f"{what}: tone not recovered ({hz} Hz)")
            print(f"  {what} tone {hz:.1f} Hz")

        wbfm = ["-f", "100.3M", "-M", "wbfm", "-d", WBFM_SYNTH,
                "--blocks", str(WBFM_BLOCKS)]
        pcm, _ = card_vs_cpu("-E hq (wbfm)", wbfm + ["-E", "hq"], tmp)
        print(f"  -E hq tone {tone_hz(pcm):.1f} Hz")
        pcm, counts = card_vs_cpu("--int-audio (wbfm)",
                                  wbfm + ["--int-audio"], tmp, exact=True)
        if counts["int_deemph"] <= 0:
            fail("--int-audio did not launch int_deemph")
        if not np.array_equal(pcm, int_pcm):
            fail("phase 6's stepped --int-audio chain differs from the CLI's "
                 "bytes: its int_deemph inputs are not the CLI's")

        # -b 1 against the chunked runner, and checkpoint/resume, at -s 24k
        # (no de-emphasis, no resampler: every engine gives the same bytes)
        fm24 = ["-f", "100M", "-s", "24k", "-d", "synth=fm,audio=1k,dev=9k,"
                "amp=0.8,noise=0.01,carrier=100M,seed=7"]
        chunked, _ = cli(fm24 + ["--blocks", "48"], Path(tmp) / "a.raw")
        per_block, counts = cli(fm24 + ["-b", "1", "--blocks", "48"],
                                Path(tmp) / "b.raw")
        # one K1 launch a block, plus the runner's warmup block
        if counts["capture_frontend_mm_pallas"] < 48:
            fail(f"-b 1 did not launch K1 once a block ({counts})")
        if chunked.size != per_block.size or chunked.size == 0:
            fail(f"-b 1 gave {per_block.size} PCM samples, the chunked "
                 f"runner {chunked.size}")
        if not np.array_equal(chunked, per_block):
            fail("-b 1 differs from the chunked runner by "
                 f"{np.abs(chunked.astype(int) - per_block).max()} LSB")
        print(f"-b 1 vs chunked runner on the card: identical "
              f"({chunked.size} PCM samples), launches {counts}")
        ck, out = Path(tmp) / "st.npz", Path(tmp) / "o.wav"
        ref_wav = Path(tmp) / "ref.wav"
        cli(fm24 + ["-E", "wav", "--blocks", "48"], ref_wav)
        cli(fm24 + ["-E", "wav", "--checkpoint", str(ck), "--blocks", "20"],
            out)
        cli(fm24 + ["-E", "wav", "--resume", str(ck), "--blocks", "48"], out)
        if out.read_bytes() != ref_wav.read_bytes():
            fail("interrupted + resumed run differs from an uninterrupted one")
        cfg24 = fmchain.plan_capture(fmchain.FmConfig(), 100e6)[0]
        on_cpu, meta = checkpoint.load_checkpoint(
            str(ck), fmchain.init_state(cfg24, "cpu"))
        leaves = checkpoint.tree_leaves(on_cpu)
        if meta["blocks"] != 48 or not all(
                t.device.type == "cpu" for t in leaves):
            fail(f"the card's checkpoint did not load on the CPU ({meta})")
        print(f"checkpoint: interrupted at 20 blocks + resumed = the "
              f"uninterrupted bytes; the card's checkpoint ({len(leaves)} "
              f"leaves, {meta['blocks']} blocks) loads on the CPU")

        # scanning: the first frequency is silent, so the scanner must hop
        from rx_tools_tpu_torch.iq import sources
        tunes = []
        set_freq = sources.SynthSource.set_frequency

        def counting(self, f):
            tunes.append(f)
            return set_freq(self, f)

        with patched(sources.SynthSource, "set_frequency", counting):
            pcm, counts = cli(["-f", "102.3M", "-f", "100.3M", "-M", "wbfm",
                               "-l", "20", "-d", WBFM_SYNTH, "--blocks",
                               "64"], Path(tmp) / "scan.raw")
        hops = len(tunes) - 1
        hz = tone_hz(pcm) if pcm.size > 4000 else 0.0
        print(f"scanning: {hops} hop(s), {pcm.size} PCM samples, tone "
              f"{hz:.1f} Hz, launches {counts}")
        if hops < 1 or pcm.size == 0 or abs(hz - 1000.0) > 10:
            fail("scanning did not hop to the station and emit its audio")

    # ---- phase 8: rx_power -----------------------------------------------
    def counted(fn):
        """``fn()`` on the card with every count from 0: (result, counts)."""
        reset_counts()
        result = fn()
        counts = {k: f.launches for k, f in counters.items()}
        for k, v in counts.items():
            path_counts[k].append(v)
        return result, counts

    with tempfile.TemporaryDirectory() as tmp:
        rx_power_phase(dev, counted, Path(tmp))

    # ---- phase 9: sources on the card --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cfg1_cu8 = sources_phase(counted, Path(tmp))

    # ---- phase 10: rx_channels -------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        channels_phase(counted, Path(tmp))

    # ---- phase 11: parallel/ on one card ------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path_counts["capture_frontend_mm_pallas"].append(
            parallel_phase(dev, cfg, synth, counted, Path(tmp)))

    # ---- phase 12: the hardware-soak twin -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        soak_phase(cfg1_cu8, Path(tmp))

    # ---- phase 13: the record ----------------------------------------------
    kern["int_deemph"] = deemph
    lines = []
    for name, k in kern.items():
        lines.append({"name": name, "route": "cuda", "source": k["source"],
                      "replaces": k["replaces"],
                      "launches": sum(path_counts[name]),
                      "max_abs_err": k["err"], "ms": k["ms"],
                      "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                      "bound_by": k["bound_by"],
                      "library_ms": k.get("library_ms")})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
