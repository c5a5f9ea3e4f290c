"""``rx_power`` — wideband FFT power-spectrum logger, on CUDA.

Counterpart of :mod:`rx_tools_tpu.apps.rx_power`, argument-compatible with
the reference (``src/rtl_power.c:119-173,848-932``): ``-f lo:hi:max_bin``,
``-i`` interval, ``-1`` single-shot, ``-e`` exit timer, ``-d/-g/-p/-C/-a``
device config, ``-w`` window, ``-c`` crop, ``-F`` fir, ``-P`` peak hold,
``-D`` direct, ``-O`` offset tuning, ``-S`` settle, ``-R`` retries,
``--checkpoint``/``--resume`` and ``--int-fft``; CSV rows ``date, time, Hz
low, Hz high, Hz step, samples, dB, ...`` (``rtl_power.c:1044-1050``) on
stdout or the named file, every log line on stderr.

Each sweep reads all hops on the host (retune, settle-and-flush, one read
a hop, ``retune``, ``rtl_power.c:548-580``), copies the ``(H, buf_len)``
int16 blocks to the card once and integrates them in one batched device
step (``models/powerscan.py``); the float accumulators stay on the card
until a CSV flush or a checkpoint copies them back.  ``--int-fft`` runs the
reference's fix_fft bit-exactly on the card and accumulates exactly in
int64 on the host, like the reference package.  ``RX_PLATFORM=cpu`` runs
everything on the CPU.

Two-stage SIGINT kept (``rtl_power.c:175-204``): first ^C finishes the
current pass and flushes, second aborts mid-sweep.

Scaling, as in the reference package: ``-t N`` shards the hop rows over N
of this process's devices (``parallel/hopshard.py``; default all of
``device.local_devices()``, one on a one-card host), the rows padded to a
multiple of the mesh and the pad rows never flushed; a multi-process job
(``parallel/multihost.py``, the reference package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``)
gives each process its own contiguous slice of the tune table, single-sources
the flush and stop decisions from the primary, gathers the accumulators at
each flush (int64 exactly for ``--int-fft``) and lets only the primary write
the CSV.

Run: ``python -m rx_tools_tpu_torch.apps.rx_power -f 88M:108M:125k -1
-d synth=tone,carrier=100.3M sweep.csv``.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

import numpy as np
import torch

from rx_tools_tpu_torch.apps import common
from rx_tools_tpu_torch.device import local_devices, resolve_device
from rx_tools_tpu_torch.models import powerscan
from rx_tools_tpu_torch.models.power_plan import plan_sweep, describe_plan
from rx_tools_tpu_torch.utils.logging import log
from rx_tools_tpu_torch.utils.units import atofs, atoft, atofp

USAGE = """rx_power (rx_tools_tpu_torch), an FFT logger for SoapySDR-style sources

Use:\trx_power -f freq_range [-options] [filename]
\t-f lower:upper:bin_size [Hz]
\t (bin size is a maximum, smaller more convenient bins will be used.
\t  valid range 1Hz - 2.8MHz)
\t[-i integration_interval (default: 10 seconds)]
\t[-1 enables single-shot mode (default: off)]
\t[-e exit_timer (default: off/0)]
\t[-C channel number (ex: 0)]
\t[-a antenna (ex: 'Tuner 1 50 ohm')]
\t[-d device key/value query (ex: file=cap.bin, synth=tone)]
\t[-g tuner gain(s) (ex: 20, 40, LNA=40,VGA=20,AMP=0)]
\t[-p ppm_error (default: 0)]
\t[-S tuner_sleep_usec (default: 5000)]
\t[-R tuner_retry_max (default: 3)]
\tfilename (a '-' dumps samples to stdout)
\t[-w window (default: rectangle)]
\t (hamming, blackman, blackman-harris, hann-poisson, bartlett, youssef)
\t[-c crop_percent (default: 0%, recommended: 20%-50%)]
\t[-F fir_size (default: disabled), 0 or 9]
\t[-P enables peak hold (default: off)]
\t[-D direct_sampling_mode, 0 (default/off), 1 (I), 2 (Q), 3 (no-mod)]
\t[-O enable offset tuning (default: off)]
\t[-t device parallelism: shard hops over this many devices
\t (default: 0 = all local devices; 1 disables sharding.
\t  the reference parsed but never used '-t fft_threads' — here it is live)]
\t[--checkpoint path  snapshot integration accumulators every sweep, so a
\t killed run resumes mid-interval instead of losing it]
\t[--resume path  restore accumulators from a snapshot]
\t[--int-fft  bit-exact integer fidelity tier: the reference's fix_fft
\t (Q14 rounding, per-stage >>1, int16 wraps) runs on device and the CSV
\t matches the C binary bit-for-bit (boxcar path; composes with
\t multi-process sweeps, -t device sharding and --checkpoint)]

CSV FFT output columns:
\tdate, time, Hz low, Hz high, Hz step, samples, dbm, dbm, ...
"""


def usage():
    sys.stderr.write(USAGE + "\n")
    raise SystemExit(1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.getopt(argv, "a:C:f:i:s:t:d:g:p:e:w:c:F:1PD:OS:R:h",
                                   ["checkpoint=", "resume=", "int-fft"])
    except getopt.GetoptError as e:
        log("%s", str(e))
        usage()

    freq_arg = None
    interval = 10.0
    single = False
    exit_timer = 0.0
    channel = 0
    antenna = None
    dev_query = ""
    gain_str = None
    ppm_error = 0.0
    window_name = "rectangle"
    crop = 0.0
    fir_size = -1
    peak_hold = False
    direct_sampling = 0
    offset_tuning = False
    tuner_sleep_usec = 5000
    tuner_retry_max = 3
    checkpoint_path = None
    resume_path = None
    int_fft = False
    dev_parallel = 0            # 0 = all local devices

    for opt, arg in opts:
        if opt == "-f":
            freq_arg = arg
        elif opt == "-i":
            interval = atoft(arg)
        elif opt == "-1":
            single = True
        elif opt == "-e":
            exit_timer = atoft(arg)
        elif opt == "-C":
            channel = int(arg)
        elif opt == "-a":
            antenna = arg
        elif opt == "-d":
            dev_query = arg
        elif opt == "-g":
            gain_str = arg
        elif opt == "-p":
            ppm_error = atofs(arg)
        elif opt == "-w":
            window_name = arg       # registry keys match the -w spellings
        elif opt == "-c":
            crop = atofp(arg)
        elif opt == "-F":
            fir_size = int(arg)
        elif opt == "-P":
            peak_hold = True
        elif opt == "-D":
            direct_sampling = int(arg)
        elif opt == "-O":
            offset_tuning = True
        elif opt == "-S":
            tuner_sleep_usec = int(arg)
        elif opt == "-R":
            tuner_retry_max = int(arg)
        elif opt == "-t":
            # the reference parses '-t fft_threads' and never uses it
            # (rtl_power.c:899-901 dead flag); here it selects how many
            # devices the hop axis shards over
            dev_parallel = int(arg)
        elif opt == "--checkpoint":
            checkpoint_path = arg
        elif opt == "--resume":
            resume_path = arg
        elif opt == "--int-fft":
            int_fft = True
        elif opt == "-h":
            usage()

    if freq_arg is None:
        usage()
    parts = freq_arg.split(":")
    if len(parts) != 3:
        log("use -f lower:upper:bin_size")
        return 1
    lower, upper, max_size = atofs(parts[0]), atofs(parts[1]), atofs(parts[2])

    boxcar = fir_size < 0
    comp_fir_size = fir_size if fir_size > 0 else 0
    tunes = plan_sweep(lower, upper, max_size, crop, boxcar=boxcar)
    log("Reporting every %0.f seconds", interval)
    for line in describe_plan(tunes):
        log("%s", line)

    device = resolve_device()
    from rx_tools_tpu_torch.parallel import multihost
    try:
        pid = multihost.init()
    except RuntimeError as e:
        log("rx_power: %s", str(e))
        return 1

    # --- multi-process sweep division ---------------------------------------
    # each process retunes, reads and integrates only its own contiguous
    # slice of the tune table; the primary stitches the gathered
    # accumulators into the CSV (the reference's serial hop loop,
    # rtl_power.c:670-772, divided across processes)
    n_proc = multihost.process_count()
    hops_per_proc = len(tunes)
    my_tunes = tunes
    if n_proc > 1:
        hops_per_proc = -(-len(tunes) // n_proc)       # uniform across procs
        my_lo = pid * hops_per_proc
        my_tunes = tunes[my_lo: my_lo + hops_per_proc]
        log("Multi-process sweep: process %d/%d owns hops %d..%d of %d.",
            pid, n_proc, my_lo, my_lo + len(my_tunes) - 1, len(tunes))

    # two-stage SIGINT (rtl_power.c:175-204)
    bail = [0]

    def sig(*a):
        bail[0] += 1
        if bail[0] == 1:
            log("Signal caught, finishing pass.")
        else:
            log("Signal caught, aborting.")

    common.install_sigint(sig)

    with common.suppress_stdout():
        src = common.verbose_device_search(dev_query)
        if direct_sampling:
            common.verbose_direct_sampling(src, direct_sampling)
        if offset_tuning:
            common.verbose_offset_tuning(src)
        if antenna:
            common.verbose_antenna_str_set(src, antenna)
        common.verbose_gain_str_set(src, gain_str)
        common.verbose_ppm_set(src, ppm_error)
        src.channel = channel
        common.verbose_set_sample_rate(src, tunes[0].rate)

    out = common.open_output(args[0] if args else None)

    t0 = tunes[0]
    cfg = powerscan.PowerConfig(
        bin_e=t0.bin_e, downsample=t0.downsample,
        downsample_passes=t0.downsample_passes,
        boxcar=boxcar, comp_fir_size=comp_fir_size,
        window=window_name, peak_hold=peak_hold, buf_len=t0.buf_len)

    # --- opt-in bit-exact integer plane (--int-fft) -------------------------
    # the C scanner's integer quirks run on the device (ops/intfft.py),
    # int64 accumulation on the host, CSV bit-identical to the reference
    # binary (rtl_power.c:714-770)
    iavg = isamples = None
    if int_fft:
        if not boxcar:
            log("--int-fft supports the boxcar decimation path only "
                "(drop -F).")
            return 1
        if cfg.bin_e > 0:
            try:    # shape/overflow validation
                powerscan.int_sweep_powers(
                    cfg, np.zeros((1, cfg.buf_len), np.int16), device)
            except ValueError as e:
                log("%s", str(e))
                return 1
        else:
            dev_parallel = 1  # giant-bin path accumulates host-side

    # --- hop-axis sharding over this process's devices ----------------------
    # every device integrates its own hop rows; the accumulators stay on
    # their devices until a flush reads them (parallel/hopshard.py)
    devs = local_devices(device)
    want = len(devs) if dev_parallel <= 0 else min(dev_parallel, len(devs))
    n_mesh = max(1, min(want, hops_per_proc))
    mesh = None
    h_pad = hops_per_proc
    if n_mesh > 1:
        from rx_tools_tpu_torch.parallel import make_mesh
        mesh = make_mesh(n_mesh, axis="h", devices=devs)
        h_pad = -(-hops_per_proc // n_mesh) * n_mesh  # rows: mesh multiple
        log("Sharding %d hops over %d devices (%d rows incl. padding).",
            len(my_tunes), n_mesh, h_pad)
    acc = powerscan.new_sweep_accum(h_pad, cfg, device)
    if int_fft:
        iavg = np.zeros((h_pad, cfg.bin_len), np.int64)
        isamples = np.zeros(h_pad, np.int64)

    # --- checkpoint/resume of the integration accumulators -----------------
    # the reference loses at most one -i interval on a kill (append-only CSV,
    # rtl_power.c:813-816); with --checkpoint even that interval survives
    if resume_path and checkpoint_path is None:
        checkpoint_path = resume_path
    ckpt_meta = {"h_pad": h_pad, "bin_e": cfg.bin_e, "buf_len": cfg.buf_len,
                 "n_tunes": len(tunes), "n_proc": n_proc, "pid": pid,
                 "int_fft": bool(int_fft)}
    if resume_path:
        from rx_tools_tpu_torch.stream.checkpoint import (load_checkpoint,
                                                          read_meta)
        if not os.path.exists(resume_path):
            log("resume: no checkpoint at %s yet — starting fresh.",
                resume_path)
        else:
            meta = read_meta(resume_path)   # validate before loading leaves
            if {k: meta.get(k) for k in ckpt_meta} != ckpt_meta:
                log("resume: checkpoint plan %s does not match current "
                    "sweep plan %s (different flags?)", meta, ckpt_meta)
                return 1
            if int_fft:
                loaded, _ = load_checkpoint(
                    resume_path, powerscan.SweepAccum(iavg, isamples))
                iavg, isamples = loaded
                log("Resumed integration (%d samples accumulated).",
                    int(isamples.max(initial=0)))
            else:
                acc, _ = load_checkpoint(resume_path, acc)
                log("Resumed integration (%d samples accumulated).",
                    int(acc.samples.max()))

    def save_ckpt(a):
        if checkpoint_path is None:
            return
        from rx_tools_tpu_torch.stream.checkpoint import save_checkpoint
        if hasattr(a, "gathered"):
            a = a.gathered()         # one file layout, sharded or not
        save_checkpoint(checkpoint_path, a, meta=ckpt_meta)

    start = time.time()
    next_tick = start + interval
    # deterministic work accounting (one line at exit), the reference
    # package's: sweeps completed and hops read
    sweep_passes = 0
    hop_reads = 0
    # stdout stays suppressed through activation (driver chatter must not
    # reach the data plane; rtl_fm.c:880, convenience.c:447-466)
    with common.suppress_stdout():
        src.activate()
    try:
        while True:
            # one sweep: retune + read this process's hops on the host, then
            # integrate them in one batched (and hop-sharded) device step;
            # pad rows stay zero, never flushed
            blocks = np.zeros((h_pad, t0.buf_len), np.int16)
            aborted, reads = read_sweep(src, my_tunes, blocks, bail,
                                        tuner_sleep_usec, tuner_retry_max)
            hop_reads += reads
            if not aborted:
                sweep_passes += 1
                if int_fft:
                    _int_sweep(cfg, blocks, iavg, isamples, device, mesh)
                elif mesh is not None:
                    from rx_tools_tpu_torch.parallel import hop_sharded_sweep
                    acc = hop_sharded_sweep(cfg, acc, blocks, mesh)
                else:
                    acc = powerscan.sweep_step(cfg, acc, blocks)
                save_ckpt(powerscan.SweepAccum(iavg, isamples)
                          if int_fft else acc)
            now = time.time()
            want_flush = bool(now >= next_tick or single or bail[0])
            want_stop = bool(single or bail[0]
                             or (exit_timer and now - start >= exit_timer))
            if n_proc > 1:
                # control decisions single-sourced from the primary, so
                # every process enters the flush gather in lockstep (the
                # controller-thread pattern of rtl_fm.c:999-1050)
                f = multihost.broadcast_flags(
                    np.array([int(want_flush), int(want_stop)], np.int32))
                want_flush, want_stop = bool(f[0]), bool(f[1])
            if want_flush:
                if int_fft:
                    _flush_csv(out, tunes, cfg,
                               powerscan.SweepAccum(iavg, isamples),
                               hops_per_proc)
                    iavg[:] = 0
                    isamples[:] = 0
                    save_ckpt(powerscan.SweepAccum(iavg, isamples))
                else:
                    _flush_csv(out, tunes, cfg, acc, hops_per_proc)
                    acc = powerscan.new_sweep_accum(h_pad, cfg, device)
                    save_ckpt(acc)     # persist the post-flush reset too
                while next_tick <= now:
                    next_tick += interval
            if want_stop:
                break
    finally:
        log("Sweep summary: %d passes, %d hop reads (%d hops owned of %d).",
            sweep_passes, hop_reads, len(my_tunes), len(tunes))
        src.deactivate()
        src.close()
        if out is not sys.stdout.buffer:
            out.close()
        else:
            out.flush()
    return 0


def read_sweep(src, tunes, blocks, bail, sleep_usec, retry_max):
    """Retune to and read every hop of one sweep into ``blocks`` (H,
    buf_len) int16 on the host.  Returns ``(aborted, hop_reads)``: a second
    SIGINT or a source that ends aborts the sweep (and asks the loop to
    stop)."""
    reads = 0
    for i, t in enumerate(tunes):
        if bail[0] >= 2:
            return True, reads
        if src.get_frequency() != t.freq:
            _retune(src, t.freq, sleep_usec, retry_max)
        n, buf = src.read_stream(t.buf_len // 2)
        if n <= 0:
            bail[0] = max(bail[0], 1)
            return True, reads
        blocks[i, : 2 * n] = buf[: 2 * n]
        blocks[i, 2 * n:] = 0
        reads += 1
    return False, reads


def _int_sweep(cfg, blocks, iavg, isamples, device, mesh=None) -> None:
    """``--int-fft``: bit-exact per-segment powers on the device (sharded
    over ``mesh`` when given), reduced over segments there in int64 (exact)
    and added into the host int64 accumulators in place."""
    h = blocks.shape[0]
    if cfg.bin_e == 0:
        from rx_tools_tpu_torch.ops.intfft import rms_power_int
        for i in range(h):
            p = rms_power_int(blocks[i])
            iavg[i, 0] = max(iavg[i, 0], p) if cfg.peak_hold \
                else iavg[i, 0] + p
            isamples[i] += 1
        return
    if mesh is not None:
        from rx_tools_tpu_torch.parallel.hopshard import int_hop_sharded
        p = int_hop_sharded(cfg, blocks, mesh)
    else:
        p = powerscan.int_sweep_powers(cfg, blocks, device)
    if cfg.peak_hold:
        iavg[:] = np.maximum(iavg, p.amax(dim=1).cpu().numpy())
    else:
        iavg += p.sum(dim=1, dtype=torch.int64).cpu().numpy()
    isamples += p.shape[1] * cfg.downsample


def _retune(src, freq, sleep_usec, retry_max):
    """setFrequency + settle + flush reads (retune, rtl_power.c:548-580)."""
    src.set_frequency(freq)
    time.sleep(sleep_usec / 1e6)
    for _ in range(retry_max):
        n, _ = src.read_stream(4096)
        if n > 0:
            return
    log("WARNING: read_stream failed to settle, try increasing -S or -R")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flush_csv(out, tunes, cfg, acc, hops_per_proc=None) -> None:
    """Timestamped CSV rows per hop (rtl_power.c:1041-1051, 774-817): the
    accumulators' one copy back from the device(s).  In a multi-process job
    every process calls this (the gather is collective): process p owns the
    hop rows [p*hops_per_proc, (p+1)*hops_per_proc); only the primary
    writes."""
    from rx_tools_tpu_torch.parallel import multihost
    avg = _host(acc.avg)
    samples = _host(acc.samples)
    if multihost.process_count() > 1:
        per = hops_per_proc
        gather = (multihost.allgather_exact_i64 if avg.dtype == np.int64
                  else multihost.allgather)
        avg = gather(avg[:per]).reshape(-1, avg.shape[-1])
        samples = gather(samples[:per]).reshape(-1)
    stamp = time.strftime("%Y-%m-%d, %H:%M:%S")
    lines = []
    for i, t in enumerate(tunes):
        lo, hi, step, s, dbms = powerscan.csv_row_values(
            avg[i], int(samples[i]), cfg, t.freq, t.rate, t.crop)
        vals = ", ".join("%.2f" % d for d in dbms)
        lines.append(f"{stamp}, {lo}, {hi}, {step:.2f}, {s}, {vals}\n")
    if multihost.is_primary():
        out.write("".join(lines).encode() if _binary(out)
                  else "".join(lines))
        out.flush()


def _binary(f) -> bool:
    return hasattr(f, "mode") and "b" in getattr(f, "mode", "b") or f is sys.stdout.buffer


if __name__ == "__main__":
    raise SystemExit(main())
