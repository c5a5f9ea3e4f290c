"""``rx_channels`` — demodulate many stations from one capture, on CUDA.

Counterpart of :mod:`rx_tools_tpu.apps.rx_channels` (beyond the
reference: rx_fm does one channel per process per dongle,
``src/rtl_fm.c:189-193``), flag for flag:

- ``-n D``: polyphase filterbank (``models/pfb.py``), D uniform channels
  spaced fs/D across the capture;
- ``-k f1[,f2,...]``: mixer channelizer (``models/channelizer.py``),
  arbitrary station frequencies, ``-D`` the per-channel decimation.

Each channel's audio goes to ``<outdir>/chNN_<freq>.s16`` (16-bit PCM).
Engines as in the reference package: the PFB runs time-major unless
``RX_PFB=cm``, the mode is raw or the channel-rate block is not a multiple
of 128; the mixer runs time-major unless ``RX_MIXER=cm`` or
``tmaj_supported`` says no.  The time-major engines take up to
``RX_CHANNELS_CHUNK`` (default 8) blocks a dispatch, with the same bytes
as one block a dispatch.  PCM is quantised to int16 on the card and only
int16 crosses to the host, one chunk behind the dispatch.

Scaling, as in the reference package: ``-t N`` shards the PFB's channel
axis over N of this process's devices (``parallel/chanshard.py``, the
channel-major engine per shard), and a multi-process job
(``parallel/multihost.py``, the reference package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``)
divides the channels (``-n``) or stations (``-k``) across processes with no
communication: each process computes and writes only its own channels from
the same deterministic file or synth source.  A process left with no
channel logs so and exits 0.  ``RX_PLATFORM=cpu`` runs everything on the
CPU.

    python -m rx_tools_tpu_torch.apps.rx_channels -f 98M -s 2.4M -n 64 \\
        -M fm -A fast -c us -r 32k -d file=band.cs16,rate=2.4M out/
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.apps import common
from rx_tools_tpu_torch.device import local_devices, resolve_device
from rx_tools_tpu_torch.models import channelizer, pfb
from rx_tools_tpu_torch.models.fmchain import as_block
from rx_tools_tpu_torch.utils.logging import log
from rx_tools_tpu_torch.utils.units import atofs

USAGE = """rx_channels (rx_tools_tpu_torch), multi-channel demodulator

Usage:\t -f center_frequency [Hz]
\t[-s capture samplerate (default: 2400000 Hz)]
\t[-n channels: polyphase filterbank, n uniform channels]
\t[-k f1[,f2,...]: mixer engine, explicit station frequencies]
\t[-D decimation for -k (default: 16)]
\t[-M mode fm|am|usb|lsb|raw (default: fm)]
\t[-A std|fast|lut|ale atan mode (default: fast)]
\t[-c deemphasis us|eu|N_us|off (default: us)]
\t[-r audio resample rate (default: 32k; 0 = channel rate)]
\t[-b block size in capture samples (default: 131072)]
\t[-e exit after N seconds of signal]
\t[-d device key/value query] [-g gain] [-p ppm] [-a antenna]
\t[-t devices: shard -n channels over this many local devices]
\toutput directory (channel files chNN_<freq>.s16)
"""


def usage():
    sys.stderr.write(USAGE + "\n")
    raise SystemExit(1)


def to_int16(audio: torch.Tensor) -> torch.Tensor:
    """Float PCM -> int16 on the audio's device, C truncation
    (``fmchain.audio_to_int16``'s trunc(clip))."""
    return torch.trunc(torch.clamp(audio, -32768, 32767)).to(torch.int16)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.getopt(argv, "f:s:n:k:D:M:A:c:r:b:e:d:g:p:a:t:")
    except getopt.GetoptError as e:
        log("%s", str(e))
        usage()

    freq = None
    rate = 2_400_000
    n_uniform = 0
    stations: list[float] = []
    decim = 16
    mode = "fm"
    atan = "fast"
    deemph_arg = "us"
    rate_out2 = 32_000
    block_target = 131072
    exit_s = 0.0
    dev_query = ""
    gain_str = None
    ppm = 0.0
    antenna = None
    dev_parallel = 1

    for opt, arg in opts:
        if opt == "-f":
            freq = atofs(arg)
        elif opt == "-s":
            rate = int(atofs(arg))
        elif opt == "-n":
            n_uniform = int(arg)
        elif opt == "-k":
            stations = [atofs(v) for v in arg.split(",") if v]
        elif opt == "-D":
            decim = int(arg)
        elif opt == "-M":
            mode = arg
        elif opt == "-A":
            atan = arg
        elif opt == "-c":
            deemph_arg = arg
        elif opt == "-r":
            rate_out2 = int(atofs(arg))
        elif opt == "-b":
            block_target = int(atofs(arg))
        elif opt == "-e":
            exit_s = float(atofs(arg))
        elif opt == "-d":
            dev_query = arg
        elif opt == "-g":
            gain_str = arg
        elif opt == "-p":
            ppm = atofs(arg)
        elif opt == "-a":
            antenna = arg
        elif opt == "-t":
            dev_parallel = int(arg)

    outdir = args[0] if args else None
    if outdir is None or freq is None:
        usage()
    if bool(n_uniform) == bool(stations):
        log("exactly one of -n (PFB) or -k (mixer stations) is required")
        return 1
    if mode not in ("fm", "am", "usb", "lsb", "raw"):
        log("unsupported mode: %s", mode)
        return 1
    device = resolve_device()
    from rx_tools_tpu_torch.parallel import multihost
    try:
        pid = multihost.init()
    except RuntimeError as e:
        log("rx_channels: %s", str(e))
        return 1
    n_proc = multihost.process_count()

    d = n_uniform if n_uniform else decim
    channel_rate = rate // d
    deemph_a = 0
    if mode == "fm" and deemph_arg != "off":
        tc_us = {"us": 75, "eu": 50}.get(deemph_arg)
        if tc_us is None:
            tc_us = int(float(deemph_arg))
        # the demod tail de-emphasises at channel_rate, before the audio
        # resampler, so alpha is computed at that rate (rtl_fm.c:1412)
        deemph_a = ops.deemph_alpha(channel_rate, tc_us)
    rate_cfg = rate_out2 if rate_out2 > 0 else -1

    # --- multi-process channel division: each process takes a contiguous
    #     slice of the channels (the replicated capture front, only its own
    #     DFT rows / mixer columns and tails) and writes only its files ----
    n_all = n_uniform or len(stations)
    chan_index0, my_hi = 0, n_all
    if n_proc > 1:
        per = -(-n_all // n_proc)
        chan_index0 = min(pid * per, n_all)
        my_hi = min(chan_index0 + per, n_all)
        if my_hi <= chan_index0:
            # more processes than channels: the reference package builds
            # empty state here (ADVICE.md:5); this process has nothing to do
            log("Multi-process channels: process %d/%d owns no channels "
                "(%d %s).", pid, n_proc, n_all,
                "channels" if n_uniform else "stations")
            return 0
        if n_uniform:
            log("Multi-process channels: process %d/%d owns channels "
                "%d..%d of %d.", pid, n_proc, chan_index0, my_hi - 1, n_all)
        else:
            log("Multi-process channels: process %d/%d owns stations "
                "%d..%d.", pid, n_proc, chan_index0, my_hi - 1)
    tmaj_layout = False
    scan_step = None
    if n_uniform:
        cfg = pfb.PfbConfig(capture_rate=rate, n_channels=n_uniform,
                            mode=mode, custom_atan=ops.disc_mode(atan),
                            deemph_a=deemph_a, rate_out2=rate_cfg)
        freqs = [freq + off for off in cfg.channel_freqs()]
        freqs = freqs[chan_index0:my_hi]
        my_n = my_hi - chan_index0
        block_size = pfb.block_samples(cfg, target=block_target)
        # the channel axis shards over this process's devices (no exchange
        # in the steady state, parallel/chanshard.py): the largest count
        # up to -t that divides the process's channels
        devs = local_devices(device)
        want = (len(devs) if dev_parallel <= 0
                else min(dev_parallel, len(devs)))
        n_mesh = next(c for c in range(min(want, my_n), 0, -1)
                      if my_n % c == 0)
        if n_mesh > 1 or n_proc > 1:
            from rx_tools_tpu_torch.parallel import (channel_sharded_pfb_step,
                                                     make_mesh)
            mesh_c = make_mesh(n_mesh, axis="c", devices=devs)
            rng_c = (chan_index0, my_hi)
            full = pfb.init_state(cfg, device)
            state = pfb.PfbState(
                tail=full.tail, prev_iq=full.prev_iq[chan_index0:my_hi],
                deemph_avg=full.deemph_avg[chan_index0:my_hi],
                resamp=type(full.resamp)(
                    full.resamp.acc[chan_index0:my_hi],
                    full.resamp.phase[chan_index0:my_hi]))

            def step(c, s, b, _m=mesh_c, _r=rng_c):
                return channel_sharded_pfb_step(c, s, b, _m, channels=_r)
            log("Sharding %d channels over %d devices.", my_n, n_mesh)
        elif (os.environ.get("RX_PFB", "tmaj") == "tmaj" and mode != "raw"
                and (block_size // n_uniform) % 128 == 0):
            state = pfb.init_state_tmaj(cfg, device)
            step = pfb.pfb_step_tmaj
            scan_step = pfb.pfb_scan_blocks_tmaj
            tmaj_layout = True
        else:
            state = pfb.init_state(cfg, device)
            step = pfb.pfb_step
    else:
        offsets = tuple(f - freq for f in stations)
        if max(abs(o) for o in offsets) > rate / 2:
            log("station %s is outside the capture bandwidth", max(stations))
            return 1
        stations = stations[chan_index0:my_hi]
        offsets = offsets[chan_index0:my_hi]
        cfg = channelizer.ChannelizerConfig(
            capture_rate=rate, offsets=offsets, downsample=decim,
            mode=mode, custom_atan=ops.disc_mode(atan), deemph_a=deemph_a,
            rate_out2=rate_cfg)
        freqs = list(stations)
        block_size = channelizer.block_samples(cfg, target=block_target)
        if (os.environ.get("RX_MIXER", "tmaj") == "tmaj"
                and channelizer.tmaj_supported(cfg, block_size)):
            state = channelizer.init_state_tmaj(cfg, device)
            step = channelizer.channelize_step_tmaj
            scan_step = channelizer.channelize_scan_blocks_tmaj
            tmaj_layout = True
        else:
            state = channelizer.init_state(cfg, device)
            step = channelizer.channelize_step

    do_exit = [False]
    common.install_sigint(lambda *a: do_exit.__setitem__(0, True))

    with common.suppress_stdout():
        src = common.verbose_device_search(dev_query)
        common.verbose_set_sample_rate(src, rate)
        common.verbose_set_frequency(src, freq)
        common.verbose_gain_str_set(src, gain_str)
        if antenna:
            common.verbose_antenna_str_set(src, antenna)
        common.verbose_ppm_set(src, ppm)
        src.activate()                 # inside the suppression window too

    if n_proc > 1:
        from rx_tools_tpu_torch.iq.sources import FileSource, SynthSource
        if not isinstance(src, (FileSource, SynthSource)):
            log("multi-process rx_channels needs a deterministic "
                "replayable source (file=/synth=).")
            return 1
    os.makedirs(outdir, exist_ok=True)
    files = [open(os.path.join(
        outdir, f"ch{chan_index0 + i:02d}_{int(round(f))}.s16"), "wb")
        for i, f in enumerate(freqs)]
    log("rx_channels: %d channels at %.0f S/s audio -> %s",
        len(freqs), float(rate_out2 if rate_out2 > 0 else channel_rate),
        outdir)

    read_total = 0
    pend = np.empty(0, np.int16)      # partial-block accumulator
    eof = False
    # chunked dispatch on the time-major engines: up to CHUNK full blocks a
    # call, the per-block steps themselves, so the bytes are per-block
    # dispatch's
    chunk_cap = (int(os.environ.get("RX_CHANNELS_CHUNK", "8"))
                 if tmaj_layout else 1)

    def emit(audio, n_valid, valid):
        if tmaj_layout:
            # time-major: (cap, C) with one shared count
            audio = audio.T
            n_valid = np.full(audio.shape[0], int(n_valid))
        frac = valid / block_size
        for i, fh in enumerate(files):
            keep = int(round(int(n_valid[i]) * frac))
            fh.write(np.ascontiguousarray(audio[i, :keep]).tobytes())

    def drain(pending):
        if pending is None:
            return
        audio_d, nv_d, vals, batched = pending
        audio_h, nv_h = audio_d.cpu().numpy(), nv_d.cpu().numpy()
        if batched:
            for j, valid in enumerate(vals):
                emit(audio_h[j], nv_h[j], valid)
        else:
            emit(audio_h, nv_h, vals)

    pending = None       # the previous chunk's results: drained after the
    try:                 # next chunk is dispatched
        while not do_exit[0] and not eof:
            fulls, valids = [], []
            while len(fulls) < chunk_cap and not do_exit[0]:
                # accumulate partial reads to a full block (a short read is
                # a stall or the tail, not EOF: only n == 0 ends)
                while pend.size < 2 * block_size:
                    n, buf = src.read_stream(block_size - pend.size // 2)
                    if n == 0:
                        eof = True
                        break
                    if n < 0:
                        sys.stderr.write("O")
                        sys.stderr.flush()
                        continue
                    pend = np.concatenate([pend, buf[: 2 * n]])
                    read_total += n
                valid = pend.size // 2
                if valid == 0:
                    break
                if valid < block_size:        # EOF tail: zero-pad + trim
                    pend = np.concatenate(
                        [pend, np.zeros(2 * (block_size - valid), np.int16)])
                fulls.append(pend[: 2 * block_size])
                valids.append(valid)
                pend = np.empty(0, np.int16)
                if eof or (exit_s and read_total >= exit_s * rate):
                    break
            if not fulls:
                break
            if tmaj_layout and len(fulls) > 1:
                state, audio_b, nv_b = scan_step(
                    cfg, state, as_block(np.stack(fulls), device))
                drain(pending)          # the previous chunk, while this runs
                pending = (to_int16(audio_b), nv_b, valids, True)
            else:
                for j, valid in enumerate(valids):
                    state, audio, n_valid = step(cfg, state,
                                                 as_block(fulls[j], device))
                    drain(pending)
                    pending = (to_int16(audio), n_valid, valid, False)
            if exit_s and read_total >= exit_s * rate:
                break
        drain(pending)
        pending = None
    finally:
        src.deactivate()
        src.close()
        for fh in files:
            fh.close()
    log("rx_channels: processed %d capture samples", read_total)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
