"""``rx_fm`` — FM/AM/SSB demodulator, I/Q in -> 16-bit PCM out, on CUDA.

Counterpart of :mod:`rx_tools_tpu.apps.rx_fm`, with the same flags
(``src/rtl_fm.c:195-260``, getopt loop ``:1224-1365``), the ``wbfm`` macro
preset (``rtl_fm.c:1331-1341``), signed 16-bit PCM on stdout (a WAV header
with ``-E wav``) and every log line on stderr.  The chain runs on the CUDA
device (``RX_PLATFORM=cpu`` runs the plain PyTorch versions on the CPU):
through the chunked runner, or the per-block ``StreamRunner`` with ``-b
1``; ``--int-audio`` runs the bit-exact integer tier block by block.
Squelch-driven scanning over several ``-f`` retunes the source between
blocks and mutes ``BUFFER_DUMP`` samples after each retune
(``rtl_fm.c:839-843``); ``--checkpoint``/``--resume`` snapshot and restore
the carried state in the reference package's format.  ``RX_PROFILE=<dir>``
writes a ``torch.profiler`` trace of the run into ``<dir>``.

``-E shard`` runs the offline time-sharded chain (``parallel/timeshard.py``)
over this process's devices (``device.local_devices``), or over every
process's in a multi-process job (``parallel/multihost.py``: the reference
package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``), where only the primary writes.

Run: ``python -m rx_tools_tpu_torch.apps.rx_fm -f 100.3M -M wbfm
-d synth=fm,audio=1k out.raw``.
"""

from __future__ import annotations

import getopt
import math
import os
import sys

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.apps import common
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner
from rx_tools_tpu_torch.utils.logging import log
from rx_tools_tpu_torch.utils.units import atofs
from rx_tools_tpu_torch.utils.wav import write_wav_header

BUFFER_DUMP = 4096
FREQUENCIES_LIMIT = 1000

USAGE = """rx_fm (rx_tools_tpu_torch), a simple narrow band FM demodulator

Use:\trx_fm -f freq [-options] [filename]
\t-f frequency_to_tune_to [Hz]
\t\tuse multiple -f for scanning (requires squelch)
\t\tranges supported, -f 118M:137M:25k
\t[-v increase verbosity (default: 0)]
\t[-M modulation (default: fm)]
\t\tfm or nbfm or nfm, wbfm or wfm, raw or iq, am, usb, lsb
\t\twbfm == -M fm -s 170k -o 4 -A fast -r 32k -l 0 -E deemp
\t\traw mode outputs 2x16 bit IQ pairs
\t[-s sample_rate (default: 24k)]
\t[-d device key/value query (ex: file=cap.bin, synth=fm)]
\t[-g tuner gain(s) (ex: 20, 40, LNA=40,VGA=20,AMP=0)]
\t[-w tuner_bandwidth (default: automatic. enables offset tuning)]
\t[-C channel number (ex: 0)]
\t[-a antenna (ex: 'Tuner 1 50 ohm')]
\t[-l squelch_level (default: 0/off)]
\t[-L N  prints levels every N calculations]
\t[-c de-emphasis_time_constant in us for wbfm. 'us' or 'eu' for 75/50 us (default: us)]
\t[-o oversampling (default: 1, 4 recommended)]
\t[-p ppm_error (default: 0)]
\t[-E enable_option (default: none)]
\t\tuse multiple -E to enable multiple options
\t\tedge, rdc, adc, dc, rtlagc, agc, deemp, direct, no-mod, offset, zero, wav
\t\thq:     high-quality DSP (polyphase sinc resampler + anti-alias
\t\t        FIR decimator; beyond the reference, ~+60 dB audio SNR)
\t\tshard:  offline multi-device demod — the whole capture is split
\t\t        into time shards (one per device) with overlap-save halo
\t\t        warm-up; single frequency, no squelch (file sources)
\t[-q dc_avg_factor for option rdc (default: 9)]
\tfilename ('-' means stdout)
Experimental options:
\t[-r resample_rate (default: none / same as -s)]
\t[-t squelch_delay (default: 10)]
\t\t+values will mute/scan, -values will exit
\t[-F fir_size (default: off)]
\t\t0 or 9: the reference's fifth-order + droop cascade
\t\t>9: windowed-sinc anti-alias FIR with that many taps (better SNR)
\t[-A std/fast/lut/ale choose atan math (default: std)]
\t[-b blocks_per_dispatch (default: 16)]
\t\tlatency/throughput knob: 1 = per-block streaming (lowest
\t\tlatency), N>1 amortizes device dispatch over N blocks
\t[--checkpoint path  periodically snapshot DSP state (resumable)]
\t[--checkpoint-every N  blocks between snapshots (default: per chunk)]
\t[--resume path  restore a snapshot; with a file output, rewinds the
\t\toutput to the snapshot point so the result is bit-identical
\t\tto an uninterrupted run (single-frequency only)]
\t[--blocks N  stop after N input blocks (offline processing)]
\t[--int-audio  bit-exact integer fidelity tier: the reference's integer
\t\taudio chain (trunc-cast rescale, integer discriminators, deemph
\t\trounding-toward-average, truncating DC block and resampler) runs
\t\ton device and the PCM matches the C bit-for-bit; fm(-A
\t\tfast/lut/ale)/am/usb/lsb, boxcar path, no squelch]

Produces signed 16 bit ints, use Sox or aplay to hear them.
"""

MODE_ALIASES = {"fm": "fm", "nbfm": "fm", "nfm": "fm", "wbfm": "wbfm",
                "wfm": "wbfm", "raw": "raw", "iq": "raw", "am": "am",
                "usb": "usb", "lsb": "lsb"}


def usage():
    sys.stderr.write(USAGE + "\n")
    raise SystemExit(1)


def parse_freq_args(freq_args: list[str]) -> list[float]:
    """Single freqs and ``lo:hi:step`` ranges (rtl_fm.c:1052-1070)."""
    freqs: list[float] = []
    for s in freq_args:
        if ":" not in s:
            freqs.append(atofs(s))
            continue
        parts = s.split(":")
        if len(parts) != 3:
            raise ValueError("use -f lower:upper:step")
        start, stop, step = (atofs(p) for p in parts)
        f = start
        while f <= stop:
            freqs.append(f)
            f += step
        if len(freqs) > FREQUENCIES_LIMIT:
            raise ValueError(f"too many frequencies (max {FREQUENCIES_LIMIT})")
    return freqs


def _iter_pieces(src, elems: int):
    """Yield the capture as int16 arrays of exactly ``elems`` elements
    (plus one final short piece), reading the source incrementally."""
    parts, total = [], 0
    while True:
        n, buf = src.read_stream(1 << 18)
        if n == 0:
            break
        if n < 0:
            sys.stderr.write("O")
            sys.stderr.flush()
            continue
        parts.append(np.asarray(buf[: 2 * n]))
        total += 2 * n
        while total >= elems:
            iq = parts[0] if len(parts) == 1 else np.concatenate(parts)
            yield iq[:elems]
            rest = iq[elems:]
            parts, total = ([rest] if rest.size else []), int(rest.size)
    if total:
        yield parts[0] if len(parts) == 1 else np.concatenate(parts)


def _run_int_audio(cfg, src, out, device, max_blocks: int = 0) -> None:
    """``--int-audio``: the bit-exact integer tier (``models/fmint.py``),
    block by block: device integer demod, host float64 seam patch, device
    integer audio post (the ``int_deemph`` kernel on the card)."""
    from rx_tools_tpu_torch.models import fmint
    from rx_tools_tpu_torch.stream.scan import stack_blocks

    bs = fmchain.block_samples(cfg)
    st = fmint.init_state(device)
    done = 0
    log("Bit-exact integer audio tier active (block %d).", bs)
    for iq in _iter_pieces(src, 8 * 2 * bs):
        blocks = stack_blocks(iq, bs)
        for i in range(blocks.shape[0]):
            st, audio = fmint.int_chain_block(cfg, st, blocks[i])
            out.write(audio.tobytes())
            done += 1
            if max_blocks and done >= max_blocks:
                return


def _run_offline_sharded(cfg, src, out, device, warmup: int = 2) -> None:
    """Offline demod over a mesh (``-E shard``): the capture streams through
    in super-chunks of S x M blocks, each split into S contiguous time
    shards with overlap-save halo warm-up (``parallel/timeshard.py`` has the
    seam semantics: FIR state exact, linear IIR state carried in closed
    form).  Host memory is bounded by one super-chunk (``RX_SHARD_BLOCKS``
    sets M; default ~128 MB), the reference's fixed-block streaming
    (``rtl_fm.c:80-88``) lifted to the mesh: super-chunk k+1's shard 0 takes
    super-chunk k's trailing blocks as its halo and its exact IIR carry.
    The tail that does not fill a super-chunk is replayed on one device
    with the same halo, so output order and emission grid match the
    streaming runner's.

    Several processes: the mesh spans every process's devices, rank-major;
    every process reads the same file or synth source in lockstep and runs
    its own shards, and only the primary writes (so N processes give the
    bytes of one process at the same total device count)."""
    from rx_tools_tpu_torch.device import local_devices
    from rx_tools_tpu_torch.iq.sources import FileSource, SynthSource
    from rx_tools_tpu_torch.parallel import multihost, time_sharded_fm
    from rx_tools_tpu_torch.parallel.mesh import Mesh
    from rx_tools_tpu_torch.parallel.timeshard import (exact_iir_supported,
                                                       resampler_modulus)
    from rx_tools_tpu_torch.stream.scan import scan_fm_blocks, stack_blocks

    n_proc = multihost.process_count()
    if n_proc > 1 and not isinstance(src, (FileSource, SynthSource)):
        log("-E shard: multi-process runs need a deterministic replayable "
            "source (file=/synth=); hardware sources are single-process.")
        raise SystemExit(1)
    mesh = (multihost.global_mesh("t") if n_proc > 1
            else Mesh(tuple(local_devices(device)), "t"))
    primary = multihost.is_primary()
    bs = fmchain.block_samples(cfg)
    s = mesh.size
    m = int(os.environ.get("RX_SHARD_BLOCKS", "0"))
    if m <= 0:
        m = max(warmup + 1, (1 << 25) // (bs * 4))   # ~128 MB a super-chunk
    fmod = resampler_modulus(cfg)
    done = 0                      # global blocks emitted so far
    tail_halo = None              # trailing `warmup` blocks of prev chunk
    iir_carry = None              # exact (deemph avg, resamp acc, dc avg)
    st = None                     # carried state once on the tail path
    logged = False

    def emit(audio, n_valid):
        if primary:
            for i in range(audio.shape[0]):
                out.write(fmchain.audio_to_int16(
                    audio[i, : int(n_valid[i])]).tobytes())

    for iq in _iter_pieces(src, s * m * 2 * bs):
        if iq.size == s * m * 2 * bs and s > 1 and m > warmup:
            # ---- sharded super-chunk ----------------------------------
            if not logged:
                log("Sharding super-chunks of %d blocks over %d devices "
                    "(%d per shard).", s * m, s, m)
                logged = True
            blocks = iq.reshape(s * m, 2 * bs)
            if tail_halo is None:
                audio, n_valid, carry = time_sharded_fm(
                    cfg, blocks.reshape(s, m, -1), mesh=mesh, warmup=warmup)
            else:
                audio, n_valid, carry = time_sharded_fm(
                    cfg, blocks.reshape(s, m, -1), mesh=mesh, warmup=warmup,
                    cont=True, halo0=tail_halo,
                    block_offset_mod=done % fmod, iir_carry=iir_carry)
            audio, n_valid = audio.cpu().numpy(), n_valid.cpu().numpy()
            iir_carry = carry[-1].cpu()
            emit(audio.reshape(s * m, -1), n_valid.reshape(-1))
            tail_halo = blocks[-warmup:].copy()
            done += s * m
            continue
        # ---- tail (or capture too short, or one device): stream it -----
        blocks = stack_blocks(iq, bs)   # partial block dropped, like the
        if not blocks.shape[0]:         # streaming runner (chunked.py)
            continue
        if st is None:
            st = fmchain.init_state(cfg, device)
            if done and cfg.rate_out2 > 0:
                apb = bs // cfg.downsample // cfg.post_downsample
                slow = cfg.rate_out2 // math.gcd(cfg.rate_out, cfg.rate_out2)
                st = st._replace(resamp=st.resamp._replace(phase=torch.tensor(
                    ((done - warmup) * apb * slow) % fmod, dtype=torch.int32,
                    device=st.prev_iq.device)))
            if done:                    # halo warm-up from the prev chunk
                st, _, _, _ = scan_fm_blocks(cfg, st, tail_halo)
                if iir_carry is not None and exact_iir_supported(cfg):
                    # the exact IIR seam: the sharded run's carry replaces
                    # the warm-up's deemph avg, window sum and DC average
                    dev = st.prev_iq.device
                    st = st._replace(
                        deemph_avg=iir_carry[0].to(dev),
                        dc_avg=iir_carry[2].to(dev),
                        resamp=st.resamp._replace(acc=iir_carry[1].to(dev)))
        # fixed-size sub-chunks, as the reference CLI replays its tail;
        # every process replays it (deterministic), only the primary emits
        for j in range(0, blocks.shape[0], 8):
            st, audio, n_valid, _ = scan_fm_blocks(cfg, st,
                                                   blocks[j: j + 8])
            emit(audio.cpu().numpy(), n_valid.cpu().numpy())


def _close(src, out) -> None:
    src.deactivate()
    src.close()
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.getopt(
            argv, "a:C:d:f:g:s:b:l:L:o:t:r:p:E:q:F:A:M:c:h:w:v",
            ["checkpoint=", "checkpoint-every=", "resume=", "blocks=",
             "int-audio"])
    except getopt.GetoptError as e:
        log("%s", str(e))
        usage()

    freq_args: list[str] = []
    mode = "fm"
    rate_in = 24000
    rate_resample = 0
    dev_query = ""
    gain_str = None
    bandwidth = 0.0
    channel = 0
    antenna = None
    squelch_level = 0.0
    level_interval = 0
    deemph_arg = "us"
    post_downsample = 1
    ppm_error = 0.0
    squelch_delay = 10
    fir_size = -1
    atan_name = "std"
    rdc_const = 9
    verbosity = 0
    enables: list[str] = []
    deemph = False
    wb_mode = False
    chunk_blocks = 16
    checkpoint_path = None
    checkpoint_every = 0
    resume_path = None
    max_blocks = None
    int_audio = False

    for opt, arg in opts:
        if opt == "-f":
            freq_args.append(arg)
        elif opt == "-M":
            if arg not in MODE_ALIASES:
                log("Unknown modulation '%s'", arg)
                usage()
            mode = MODE_ALIASES[arg]
            if mode == "wbfm":
                # preset expansion happens IN the option loop like the
                # reference's getopt case (rtl_fm.c:1331-1341), so later
                # flags (-l, -A, -r) override preset values and earlier
                # ones are clobbered — order-sensitive, faithfully.
                # (post_downsample=4 is commented out there too.)
                mode = "fm"
                wb_mode = True
                rate_in = 170000
                rate_resample = 32000
                atan_name = "fast"
                deemph = True
                squelch_level = 0.0
        elif opt == "-s":
            rate_in = int(atofs(arg))
        elif opt == "-r":
            rate_resample = int(atofs(arg))
        elif opt == "-d":
            dev_query = arg
        elif opt == "-g":
            gain_str = arg
        elif opt == "-w":
            bandwidth = atofs(arg)
        elif opt == "-C":
            channel = int(arg)
        elif opt == "-a":
            antenna = arg
        elif opt == "-l":
            squelch_level = float(atofs(arg))
        elif opt == "-L":
            level_interval = int(arg)
        elif opt == "-c":
            deemph_arg = arg
        elif opt == "-o":
            post_downsample = int(arg)
        elif opt == "-p":
            ppm_error = atofs(arg)
        elif opt == "-t":
            squelch_delay = int(arg)
        elif opt == "-F":
            fir_size = int(arg)
        elif opt == "-A":
            atan_name = arg
        elif opt == "-q":
            rdc_const = int(arg)
        elif opt == "-v":
            verbosity += 1
        elif opt == "-E":
            enables.append(arg)
        elif opt == "-b":
            chunk_blocks = max(1, int(arg))
        elif opt == "--checkpoint":
            checkpoint_path = arg
        elif opt == "--checkpoint-every":
            checkpoint_every = int(arg)
        elif opt == "--resume":
            resume_path = arg
        elif opt == "--blocks":
            max_blocks = int(arg)
        elif opt == "--int-audio":
            int_audio = True
        elif opt == "-h":
            usage()

    deemph = deemph or "deemp" in enables

    if not freq_args:
        usage()
    try:
        freqs = parse_freq_args(freq_args)
    except ValueError as e:
        log("%s", str(e))
        return 1
    if len(freqs) > 1 and squelch_level <= 0:
        log("Please specify a squelch level.  Required for scanning multiple frequencies.")
        return 1
    if len(freqs) >= FREQUENCIES_LIMIT:
        log("Too many channels, maximum %d.", FREQUENCIES_LIMIT)
        return 1
    if wb_mode:
        # controller's wbfm tuning offset (rtl_fm.c:1006-1011): nudge off
        # the station center so the DC spur lands between channels
        freqs = [f + 16000 for f in freqs]

    if resume_path and checkpoint_path is None:
        checkpoint_path = resume_path   # keep snapshotting to the same file
    if checkpoint_path and (len(freqs) > 1 or "shard" in enables):
        log("--checkpoint/--resume support single-frequency streaming runs "
            "only (no scanning, no -E shard).")
        return 1
    device = resolve_device()
    # the process group (a no-op single-process; parallel/multihost.py)
    from rx_tools_tpu_torch.parallel import multihost
    try:
        multihost.init()
    except RuntimeError as e:
        log("rx_fm: %s", str(e))
        return 1

    offset_tuning = "offset" in enables or bandwidth > 0
    edge = 1 if "edge" in enables else 0

    # rate_in *= post_downsample (rtl_fm.c:1371); rate_out keeps the -s value
    rate_demod = rate_in * post_downsample
    rate_out = rate_in

    # deemphasis coefficient (rtl_fm.c:1343-1350,1410-1415)
    deemph_a = 0
    if deemph:
        tc_us = {"us": 75, "eu": 50}.get(deemph_arg)
        if tc_us is None:
            tc_us = int(float(deemph_arg))
        deemph_a = ops.deemph_alpha(rate_out, tc_us)

    cfg = fmchain.FmConfig(
        mode=mode, rate_in=rate_demod, rate_out=rate_out,
        rate_out2=rate_resample if rate_resample > 0 else -1,
        downsample=1,
        downsample_passes=1 if 0 <= fir_size <= 9 else 0,
        comp_fir_size=fir_size if fir_size == 9 else 0,
        fir_quality=(fir_size if fir_size > 9 else
                     (64 if "hq" in enables else 0)),
        resample_quality=32 if "hq" in enables else 0,
        custom_atan=ops.disc_mode(atan_name),
        post_downsample=post_downsample, deemph_a=deemph_a,
        dc_block_audio=("dc" in enables or "adc" in enables),
        dc_block_raw="rdc" in enables,
        squelch_level=squelch_level,
        squelch_zero="zero" in enables,
        conseq_squelch=abs(squelch_delay) if squelch_delay else 10,
        offset_tuning=offset_tuning)

    # capture planning (optimal_settings, rtl_fm.c:960-997); wbfm-style
    # +16k hop offset skipped: synthetic/file sources have no DC spur
    cfg, capture_freq0, capture_rate = fmchain.plan_capture(cfg, freqs[0], edge)
    if verbosity:
        log("Oversampling input by: %ix.", cfg.downsample)
        log("Buffer size: %0.2fms",
            1000 * 0.5 * fmchain.block_samples(cfg) * 2 / capture_rate)

    # --- device setup (stdout suppressed, rtl_fm.c:1389) -----------------
    with common.suppress_stdout():
        src = common.verbose_device_search(dev_query)
        if "direct" in enables:
            common.verbose_direct_sampling(src, 1)
        if "no-mod" in enables:
            common.verbose_direct_sampling(src, 3)
        if "offset" in enables:
            common.verbose_offset_tuning(src)
        if antenna:
            common.verbose_antenna_str_set(src, antenna)
        common.verbose_gain_str_set(src, gain_str)
        # setGainMode called unconditionally with the -E rtlagc/agc flag,
        # AFTER gain setup, exactly like the reference (rtl_fm.c:1432);
        # success is only logged when the sink actually accepted it
        rtlagc = "rtlagc" in enables or "agc" in enables
        r = src.set_gain_mode(rtlagc)
        if rtlagc:
            if r == 0:
                log("Enabled digital AGC.")
            else:
                log("WARNING: Failed to enable digital AGC.")
        common.verbose_ppm_set(src, ppm_error)
        if bandwidth > 0:
            common.verbose_set_bandwidth(src, bandwidth)
        src.channel = channel
        common.verbose_set_sample_rate(src, capture_rate)
        log("Output at %u Hz.", cfg.rate_in // cfg.post_downsample)
        common.verbose_set_frequency(src, capture_freq0)

    # on resume with a file output, reopen without truncating: the stream
    # rewinds to the snapshot point below, so the result is bit-identical
    # to an uninterrupted run even after a hard kill mid-write
    out_name = args[0] if args else None
    resuming_file = (resume_path is not None and out_name not in (None, "-")
                     and os.path.exists(out_name)
                     and os.path.exists(resume_path))
    out = (open(out_name, "r+b") if resuming_file
           else common.open_output(out_name))
    header_bytes = 0
    if "wav" in enables:
        header_bytes = 44
        if not resuming_file:      # header already present when resuming
            write_wav_header(out, cfg.audio_rate(), stereo=(mode == "raw"))

    # --- bit-exact integer audio tier (--int-audio) -----------------------
    if int_audio:
        from rx_tools_tpu_torch.models import fmint
        if len(freqs) > 1 or "shard" in enables:
            log("--int-audio is a single-frequency offline tier "
                "(no scanning, no -E shard).")
            return 1
        if not fmint.supports(cfg):
            log("--int-audio covers fm (-A fast/lut/ale), am, usb, lsb on "
                "the boxcar path without squelch/raw-DC; adjust flags or "
                "drop --int-audio for the float plane.")
            return 1
        with common.suppress_stdout():
            src.activate()
        try:
            _run_int_audio(cfg, src, out, device, max_blocks)
        finally:
            _close(src, out)
        return 0

    # --- offline sharded mode (-E shard): the time axis over the mesh ----
    if "shard" in enables:
        if len(freqs) > 1 or squelch_level > 0:
            log("-E shard is an offline single-frequency mode "
                "(no squelch/scan).")
            return 1
        with common.suppress_stdout():
            src.activate()
        try:
            _run_offline_sharded(cfg, src, out, device)
        finally:
            _close(src, out)
        return 0

    # --- controller state (freq scanning) --------------------------------
    freq_idx = [0]

    def capture_freq(i: int) -> float:
        return fmchain.plan_capture(cfg, freqs[i], edge)[1]

    def on_squelch() -> bool:
        if len(freqs) <= 1:
            if squelch_delay < 0:
                runner.stop()       # -t negative: exit on squelch
            return False
        freq_idx[0] = (freq_idx[0] + 1) % len(freqs)
        src.set_frequency(capture_freq(freq_idx[0]))
        src.read_stream(BUFFER_DUMP)   # post-retune mute (rtl_fm.c:1047)
        return True

    # --- level meter (-L, rtl_fm.c:94-99,792-807) --------------------------
    # one sample per demod pass; the FIRST pass prints immediately
    # (printLevelNo starts at 1) and the mean divides by the interval, not
    # the sample count — both reference quirks kept.
    levels = {"remaining": 1, "sum": 0.0, "max": 0, "maxmax": 0}

    def note_level(lvl: float):
        if not level_interval:
            return
        lvl = int(lvl)
        levels["remaining"] -= 1
        levels["sum"] += lvl
        levels["max"] = max(levels["max"], lvl)
        levels["maxmax"] = max(levels["maxmax"], lvl)
        if levels["remaining"] == 0:
            log("%f, %d, %d, %d", levels["sum"] / level_interval,
                levels["max"], levels["maxmax"], int(squelch_level))
            levels["remaining"] = level_interval
            levels["sum"] = 0.0
            levels["max"] = 0

    def sink(audio: np.ndarray, lvl: float):
        note_level(lvl)
        pcm = fmchain.audio_to_int16(audio)
        out.write(pcm.tobytes())

    if chunk_blocks == 1:
        # -b 1: per-block StreamRunner — lowest latency; source reads
        # overlap device compute (stream/pipeline.py)
        import functools
        from rx_tools_tpu_torch.stream.pipeline import StreamRunner
        runner = StreamRunner(
            functools.partial(fmchain.fm_chain_step, cfg),
            fmchain.init_state(cfg, device), src, fmchain.block_samples(cfg),
            sink,
            on_squelch=on_squelch if len(freqs) > 1 else None,
            conseq_squelch=cfg.conseq_squelch,
            exit_on_squelch=squelch_delay < 0,
            squelch_zero=cfg.squelch_zero,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)
        runner.squelch_level = squelch_level
    else:
        runner = ChunkedFmRunner(
            cfg, src, sink, chunk=chunk_blocks,
            on_squelch=on_squelch if len(freqs) > 1 else None,
            exit_on_squelch=squelch_delay < 0, device=device,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)
    runner.warmup()

    resume_meta = None
    if resume_path:
        if not os.path.exists(resume_path):
            log("resume: no checkpoint at %s yet — starting fresh.",
                resume_path)
        else:
            from rx_tools_tpu_torch.stream.checkpoint import read_meta
            peek = read_meta(resume_path)   # validate before loading state
            if int(peek.get("block_size", -1)) != runner.block_size:
                log("resume: checkpoint block size %s != current plan %d "
                    "(different flags?)",
                    peek.get("block_size"), runner.block_size)
                return 1
            try:
                resume_meta = runner.restore(resume_path)
            except (ValueError, KeyError) as e:
                log("resume: checkpoint does not match this chain (%s)",
                    str(e))
                return 1

    common.install_sigint(lambda *a: runner.stop())

    # stdout stays suppressed through activation (driver chatter must not
    # reach the data plane; rtl_fm.c:880, convenience.c:447-466)
    with common.suppress_stdout():
        src.activate()
    if resume_meta is not None:
        if resuming_file:
            # rewind the output to the snapshot point (drops any audio
            # written after the last checkpoint before the kill)
            out.seek(header_bytes + 2 * int(resume_meta["samples_out"]))
            out.truncate()
        # skip the consumed input in the runner's own read size, so a
        # source whose stream depends on how it is read (the synth's noise
        # draws and phase sums) repeats the samples of one pass
        remaining = int(resume_meta["samples_in"])
        while remaining > 0:
            n, _ = src.read_stream(min(runner.block_size, remaining))
            if n < 0:
                continue
            if n == 0:
                log("resume: source ended during skip-ahead.")
                break
            remaining -= n
        log("Resumed at block %d (%d samples in, %d out).",
            int(resume_meta["blocks"]), int(resume_meta["samples_in"]),
            int(resume_meta["samples_out"]))
    try:
        with common.maybe_profile():
            stats = runner.run(max_blocks=max_blocks)
    finally:
        _close(src, out)
    if verbosity:
        log("Processed %d blocks (%d samples in, %d out, %.1fx realtime).",
            stats.blocks, stats.samples_in, stats.samples_out,
            stats.realtime_multiple(capture_rate))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
