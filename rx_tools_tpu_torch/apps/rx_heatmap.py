"""``rx_heatmap`` — render rx_power CSV into a PNG waterfall.

A numpy/stdlib copy of :mod:`rx_tools_tpu.apps.rx_heatmap` (no device
work): ``python -m rx_tools_tpu_torch.apps.rx_heatmap sweep.csv out.png``.

The reference's documented workflow ends with "raw data can be rendered
into a heatmap with heatmap.py" (``src/rtl_power.c:170-171`` usage text,
pointing at keenerd's external Python/PIL script).  This ships that last
step natively, with zero dependencies: a pure-stdlib PNG writer (zlib +
struct), so the full capture -> sweep -> picture pipeline runs on any
image the framework runs on.

    rx_power -f 88M:108M:10k -i 10 -e 1h fm.csv
    rx_heatmap fm.csv fm.png

Layout mirrors heatmap.py's: one pixel column per frequency bin, one
pixel row per integration interval (time flows downward), dB mapped onto
a blue -> yellow -> red gradient between ``--db lo:hi`` (default: data
percentiles 1/99).  Rows from multi-hop sweeps sharing a timestamp are
stitched onto one global frequency axis exactly as the CSV's
``hz_low + i*hz_step`` positions dictate.
"""

from __future__ import annotations

import getopt
import struct
import sys
import zlib

import numpy as np

from rx_tools_tpu_torch.utils.logging import log

USAGE = """rx_heatmap (rx_tools_tpu_torch), render rx_power CSV to a PNG waterfall

Usage:\trx_heatmap [options] input.csv output.png
\t[--db lo:hi   dB range mapped onto the palette (default: 1/99 percentiles)]
\t[--width N    downsample the frequency axis to at most N columns]
\t(input '-' reads the CSV from stdin)
"""


def usage():
    sys.stderr.write(USAGE + "\n")
    raise SystemExit(1)


# ---------------------------------------------------------------------------
# CSV -> (times, freqs, matrix)
# ---------------------------------------------------------------------------

def parse_csv(lines):
    """Parse rx_power CSV rows -> (row_keys, hz_axis_params, matrix).

    Returns ``(times, f_lo, f_step, data)`` where ``data`` is float32
    (n_times, n_bins) with NaN for never-written cells.
    """
    rows = []           # (timestamp, hz_low, hz_step, [dbs])
    for ln in lines:
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) < 7:
            continue
        ts = parts[0] + " " + parts[1]
        hz_low = float(parts[2])
        hz_step = float(parts[4])
        dbs = [float(v) for v in parts[6:] if v]
        rows.append((ts, hz_low, hz_step, dbs))
    if not rows:
        raise ValueError("no data rows in CSV")

    step = min(r[2] for r in rows)
    f_lo = min(r[1] for r in rows)
    f_hi = max(r[1] + r[2] * len(r[3]) for r in rows)
    n_bins = max(1, int(round((f_hi - f_lo) / step)))

    times = []
    index = {}
    for ts, *_ in rows:
        if ts not in index:
            index[ts] = len(times)
            times.append(ts)
    data = np.full((len(times), n_bins), np.nan, np.float32)
    for ts, hz_low, hz_step, dbs in rows:
        r = index[ts]
        for i, db in enumerate(dbs):
            c = int(round((hz_low + i * hz_step - f_lo) / step))
            if 0 <= c < n_bins:
                data[r, c] = db
    return times, f_lo, step, data


# ---------------------------------------------------------------------------
# palette + PNG writer (stdlib only)
# ---------------------------------------------------------------------------

#: heatmap.py-style stops: black -> blue -> cyan -> yellow -> red -> white
_STOPS = np.array([
    (0.0, (0, 0, 0)),
    (0.2, (0, 0, 160)),
    (0.4, (0, 160, 160)),
    (0.6, (255, 255, 0)),
    (0.8, (255, 0, 0)),
    (1.0, (255, 255, 255)),
], dtype=object)


def colorize(norm: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] (NaN -> 0) -> (H, W, 3) uint8 through the gradient."""
    norm = np.nan_to_num(norm, nan=0.0)
    norm = np.clip(norm, 0.0, 1.0)
    pos = np.array([s[0] for s in _STOPS], np.float32)
    cols = np.array([s[1] for s in _STOPS], np.float32)      # (S, 3)
    idx = np.clip(np.searchsorted(pos, norm, side="right") - 1, 0,
                  len(pos) - 2)
    t = (norm - pos[idx]) / (pos[idx + 1] - pos[idx])
    rgb = cols[idx] + (cols[idx + 1] - cols[idx]) * t[..., None]
    return rgb.astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG encoder: 8-bit RGB, filter 0 rows, one IDAT."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.getopt(argv, "h", ["db=", "width=", "help"])
    except getopt.GetoptError as e:
        log("%s", str(e))
        usage()

    db_range = None
    max_width = 0
    for opt, arg in opts:
        if opt == "--db":
            lo, _, hi = arg.partition(":")
            db_range = (float(lo), float(hi))
        elif opt == "--width":
            max_width = int(arg)
        else:
            usage()
    if len(args) != 2:
        usage()
    src, dst = args

    f = sys.stdin if src == "-" else open(src)
    try:
        times, f_lo, step, data = parse_csv(f)
    finally:
        if f is not sys.stdin:
            f.close()

    if max_width and data.shape[1] > max_width:
        # max-pool the frequency axis so narrowband peaks survive
        k = -(-data.shape[1] // max_width)
        pad = (-data.shape[1]) % k
        padded = np.pad(data, ((0, 0), (0, pad)),
                        constant_values=np.nan)
        data = np.nanmax(padded.reshape(data.shape[0], -1, k), axis=2)
        step *= k

    finite = data[np.isfinite(data)]
    if db_range is None:
        db_range = (float(np.percentile(finite, 1)),
                    float(np.percentile(finite, 99)))
    lo, hi = db_range
    if hi <= lo:
        hi = lo + 1.0
    norm = (data - lo) / (hi - lo)
    write_png(dst, colorize(norm))
    log("rx_heatmap: %d sweeps x %d bins  %.3f-%.3f MHz  %.1f..%.1f dB -> %s",
        data.shape[0], data.shape[1], f_lo / 1e6,
        (f_lo + step * data.shape[1]) / 1e6, lo, hi, dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
