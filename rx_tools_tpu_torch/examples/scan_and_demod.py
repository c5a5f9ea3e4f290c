"""Find every station in a band, then demodulate them all on one card.

Counterpart of the reference package's ``examples/scan_and_demod.py``;
composes the port's tools end to end:

1. ``rx_power`` sweeps the band into a CSV spectrum (one shot),
2. peaks above the noise floor become a station list,
3. ``rx_channels -k`` demodulates every station at once through the
   mixer channelizer.

Usage (``RX_PLATFORM=cpu`` runs it on the CPU):
    python -m rx_tools_tpu_torch.examples.scan_and_demod 100M:101M \\
        "synth=fm,carrier=100.2M|100.75M,audio=1k|440,amp=0.6" out/

    python -m rx_tools_tpu_torch.examples.scan_and_demod 88M:108M \\
        file=band.cs16,rate=2.4M out/
"""

from __future__ import annotations

import sys

import numpy as np

from rx_tools_tpu_torch.apps import rx_channels, rx_power
from rx_tools_tpu_torch.utils.units import atofs


def find_stations(csv_path: str, min_snr_db: float = 10.0,
                  min_sep: float = 150e3) -> list[float]:
    """Peak-pick an rx_power CSV: bins ``min_snr_db`` over the median,
    greedily separated by ``min_sep`` Hz, strongest first; each station is
    the power centroid of its peak's neighbourhood (a wideband FM
    spectrum's largest bin wanders inside its Carson band)."""
    freqs, dbs = [], []
    with open(csv_path) as f:
        for ln in f:
            parts = [p.strip() for p in ln.split(",")]
            if len(parts) < 7:
                continue
            lo, step = float(parts[2]), float(parts[4])
            for i, v in enumerate(parts[6:]):
                freqs.append(lo + (i + 0.5) * step)
                dbs.append(float(v))
    freqs, dbs = np.array(freqs), np.array(dbs)
    order = np.argsort(freqs)
    freqs, dbs = freqs[order], dbs[order]
    floor = np.median(dbs)
    stations: list[float] = []
    for i in np.argsort(dbs)[::-1]:
        if dbs[i] < floor + min_snr_db:
            break
        if all(abs(freqs[i] - s) >= min_sep for s in stations):
            win = np.abs(freqs - freqs[i]) <= min_sep / 2
            w = 10.0 ** (dbs[win] / 10.0)
            stations.append(float(np.sum(w * freqs[win]) / np.sum(w)))
    return sorted(stations)


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 1
    band, dev_query, outdir = argv
    lo, hi = (atofs(v) for v in band.split(":"))
    csv = f"{outdir.rstrip('/')}_scan.csv"

    rc = rx_power.main(["-f", f"{band}:10k", "-1", "-d", dev_query, csv])
    if rc != 0:
        return rc
    stations = find_stations(csv)
    if not stations:
        print("no stations found", file=sys.stderr)
        return 1
    print(f"found {len(stations)} station(s): "
          + ", ".join(f"{s/1e6:.3f}M" for s in stations), file=sys.stderr)

    center = (lo + hi) / 2
    rate = 2_400_000
    return rx_channels.main([
        "-f", f"{center:.0f}", "-s", str(rate),
        "-k", ",".join(f"{s:.0f}" for s in stations),
        "-D", "16", "-M", "fm", "-A", "fast", "-r", "32k", "-e", "1",
        "-d", dev_query, outdir])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
