"""Demodulate every FM station in a wideband capture at once.

Counterpart of the reference package's ``examples/multichannel_fm.py``:
the channel-major mixer channelizer over a CS16 file, one
``station_<freq>.raw`` (s16 PCM at 32 kHz) per station in the current
directory.  For a uniform channel grid, the polyphase filterbank CLI
(``rx_channels -n 64``) is the faster tool.

Usage (``RX_PLATFORM=cpu`` runs it on the CPU):
    python -m rx_tools_tpu_torch.examples.multichannel_fm capture.cs16 \\
        2.4M 88.1M,94.7M,101.3M [center_freq=96M]
"""

from __future__ import annotations

import sys

import numpy as np

from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models import channelizer
from rx_tools_tpu_torch.models.fmchain import audio_to_int16
from rx_tools_tpu_torch.utils.units import atofs


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 1
    path, rate, stations = argv[0], atofs(argv[1]), [
        atofs(s) for s in argv[2].split(",")]
    center = atofs(argv[3].split("=")[1]) if len(argv) > 3 else (
        (min(stations) + max(stations)) / 2)

    cfg = channelizer.ChannelizerConfig(
        capture_rate=int(rate),
        offsets=tuple(s - center for s in stations),
        downsample=max(1, int(rate // 170_000)),
        custom_atan=1, deemph_a=7, rate_out2=32_000)
    n = channelizer.block_samples(cfg)
    print(f"{len(stations)} channels, capture {rate/1e6:.2f} MS/s, "
          f"block {n} samples", file=sys.stderr)

    iq = np.fromfile(path, np.int16)
    state = channelizer.init_state(cfg, resolve_device())
    outs = [open(f"station_{int(s)}.raw", "wb") for s in stations]
    blocks = iq[: iq.size // (2 * n) * 2 * n].reshape(-1, 2 * n)
    for blk in blocks:
        state, audio, n_valid = channelizer.channelize_step(cfg, state, blk)
        audio, n_valid = audio.cpu().numpy(), n_valid.cpu().numpy()
        for c, f in enumerate(outs):
            f.write(audio_to_int16(audio[c, : n_valid[c]]).tobytes())
    for f in outs:
        f.close()
    print("done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
