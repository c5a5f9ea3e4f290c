"""Real-hardware soak of the port: check its CLIs against a physical radio.

The twin of the repository's ``tools/hw_soak.py``, on the port's CLIs.
The port's SoapySDR and rtl_tcp sources are tested against a compiled
fake library and an rtl_tcp server on localhost only; when a radio is
attached, this is the one-command check:

    python -m rx_tools_tpu_torch.hw_soak --driver driver=rtlsdr --fm-freq 100.1M
    python -m rx_tools_tpu_torch.hw_soak --rtltcp host:1234 --fm-freq 100.1M

It runs, off the air:

1. ``rx_fm -M wbfm`` for a few seconds on ``--fm-freq`` (a strong local
   broadcast station) and checks the demodulated PCM is live audio: at
   least one second, an RMS within 20-30000, and more than 80 % of the
   spectral energy below 16 kHz.
2. ``rx_power`` over ``--band`` (default the FM broadcast band) and checks
   the CSV covers the requested span to within 1 % with at least 10 dB
   between the quietest and loudest bins (dead hardware gives a flat
   noise floor).
3. If the reference C binaries (``rx_fm``/``rx_power`` of rx_tools, names
   set by ``--ref-fm``/``--ref-power``) are on PATH, the same captures
   through them, compared statistically: audio RMS within 6 dB and
   spectra correlated at 0.8 or better (two captures off the air are
   never bit-equal).

The CLIs run as subprocesses of this interpreter, so a wedged driver
cannot hang the soak; they run on the CUDA card unless the caller's
environment asks for the CPU (``RX_PLATFORM=cpu``).  The source is
``--rtltcp``, else ``--driver``, else the first SoapySDR device found
through the port's ``iq.soapy`` loader.

Exit codes: 0 = every check passed; 1 = a check failed; 2 = no usable
radio source (nothing to soak).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from rx_tools_tpu_torch.utils.units import atofs

#: the directory that holds the package, put on the CLIs' PYTHONPATH
ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(f"[hw_soak] {msg}", file=sys.stderr, flush=True)


def _run_cli(mod: str, argv: list[str], timeout: float) -> int:
    """Run one of the port's CLIs in a subprocess; a timeout is the normal
    end of a live capture (rx_fm runs until killed) and counts as 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", f"rx_tools_tpu_torch.apps.{mod}"] + argv
    log("run: " + " ".join(cmd[2:]))
    try:
        p = subprocess.run(cmd, timeout=timeout, env=env,
                           stderr=subprocess.PIPE)
    except subprocess.TimeoutExpired:
        return 0
    sys.stderr.write(p.stderr.decode(errors="replace")[-2000:])
    return p.returncode


def _source_query(args) -> str | None:
    """The radio source's ``-d`` query, or None when there is none."""
    if args.rtltcp:
        return f"rtltcp={args.rtltcp}"
    if args.driver:
        return args.driver
    from rx_tools_tpu_torch.iq.soapy import SoapySource
    try:
        SoapySource("").close()
    except RuntimeError as e:
        log(f"no SoapySDR hardware: {e}")
        return None
    return ""


def check_fm_audio(pcm_path: str, rate: int = 32000) -> bool:
    a = np.fromfile(pcm_path, np.int16).astype(np.float64)
    if a.size < rate:  # need at least a second
        log(f"FAIL: only {a.size} audio samples captured")
        return False
    a = a[rate // 2:]                      # skip the turn-on transient
    rms = float(np.sqrt(np.mean(a ** 2)))
    if not (20.0 < rms < 30000.0):
        log(f"FAIL: audio RMS {rms:.1f} outside live range")
        return False
    # live broadcast audio concentrates below 16 kHz (15 kHz mono + pilot)
    sp = np.abs(np.fft.rfft(a * np.hanning(a.size))) ** 2
    fr = np.fft.rfftfreq(a.size, 1.0 / rate)
    frac = sp[fr < 16000].sum() / max(sp.sum(), 1e-30)
    log(f"audio: {a.size} samples, RMS {rms:.0f}, {100 * frac:.1f}% "
        f"energy < 16 kHz")
    return frac > 0.8


def check_power_csv(csv_path: str, lo_hz: float, hi_hz: float) -> bool:
    with open(csv_path) as f:
        rows = [line.strip().split(", ") for line in f if line.strip()]
    if not rows:
        log("FAIL: empty CSV")
        return False
    lows = [float(r[2]) for r in rows]
    highs = [float(r[3]) for r in rows]
    dbms = np.array([float(v) for r in rows for v in r[6:]])
    span_ok = min(lows) <= lo_hz * 1.01 and max(highs) >= hi_hz * 0.99
    rng = float(dbms.max() - dbms.min())
    log(f"sweep: {len(rows)} hop rows, {dbms.size} bins, "
        f"dynamic range {rng:.1f} dB")
    if not span_ok:
        log(f"FAIL: CSV covers {min(lows):.0f}..{max(highs):.0f}, "
            f"wanted {lo_hz:.0f}..{hi_hz:.0f}")
        return False
    if rng < 10.0:
        log("FAIL: < 10 dB dynamic range — flat spectrum, dead antenna?")
        return False
    return True


def _csv_dbs(path) -> np.ndarray:
    with open(path) as f:
        return np.array([float(v) for line in f
                         for v in line.strip().split(", ")[6:]])


def compare_with_reference(args, q: str, tmp: str) -> bool:
    """The same captures through the C binaries, compared statistically;
    skipped (True) when they are not on PATH."""
    ref_fm = shutil.which(args.ref_fm)
    ref_power = shutil.which(args.ref_power)
    if not (ref_fm and ref_power):
        log("reference binaries not on PATH; skipping C comparison")
        return True
    ok = True
    rpcm = os.path.join(tmp, "ref.pcm")
    try:
        subprocess.run([ref_fm, "-f", args.fm_freq, "-M", "wbfm",
                        "-d", q, rpcm], timeout=args.seconds + 10)
    except subprocess.TimeoutExpired:
        pass
    ours = np.fromfile(os.path.join(tmp, "fm.pcm"), np.int16).astype(float)
    ref = np.fromfile(rpcm, np.int16).astype(float)
    if ref.size > 32000 and ours.size > 32000:
        r1 = np.sqrt(np.mean(ours[16000:] ** 2))
        r2 = np.sqrt(np.mean(ref[16000:] ** 2))
        db = 20 * np.log10(max(r1, 1e-9) / max(r2, 1e-9))
        log(f"vs C rx_fm: RMS {r1:.0f} vs {r2:.0f} ({db:+.1f} dB)")
        if abs(db) > 6.0:
            log("FAIL: audio level differs from the C binary by > 6 dB")
            ok = False
    rcsv = os.path.join(tmp, "ref.csv")
    subprocess.run([ref_power, "-f", args.band, "-1", "-d", q, rcsv],
                   timeout=300)
    a = _csv_dbs(os.path.join(tmp, "power.csv"))
    b = _csv_dbs(rcsv)
    n = min(a.size, b.size)
    if n > 64:
        corr = float(np.corrcoef(a[:n], b[:n])[0, 1])
        log(f"vs C rx_power: spectrum correlation {corr:.3f} over {n} bins")
        if corr < 0.8:
            log("FAIL: sweep spectra decorrelated from the C binary")
            ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--driver", default="",
                    help="SoapySDR device query (e.g. driver=rtlsdr)")
    ap.add_argument("--rtltcp", default="",
                    help="rtl_tcp endpoint host:port (no SoapySDR needed)")
    ap.add_argument("--fm-freq", default="100.1M",
                    help="a strong local FM broadcast frequency")
    ap.add_argument("--band", default="88M:108M:100k",
                    help="rx_power sweep range lo:hi:bin")
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="FM capture length")
    ap.add_argument("--ref-fm", default="rx_fm",
                    help="reference C rx_fm binary name for comparison")
    ap.add_argument("--ref-power", default="rx_power")
    args = ap.parse_args(argv)

    q = _source_query(args)
    if q is None:
        log("no hardware source available — nothing to soak (exit 2)")
        return 2

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        pcm = os.path.join(tmp, "fm.pcm")
        t0 = time.time()
        _run_cli("rx_fm", ["-f", args.fm_freq, "-M", "wbfm",
                           "-d", q, pcm], timeout=args.seconds)
        log(f"FM capture: {time.time() - t0:.1f} s")
        ok &= check_fm_audio(pcm)

        csv = os.path.join(tmp, "power.csv")
        rc = _run_cli("rx_power", ["-f", args.band, "-1", "-d", q, csv],
                      timeout=600)
        ok &= (rc == 0)
        lo, hi = args.band.split(":")[:2]
        ok &= check_power_csv(csv, atofs(lo), atofs(hi))

        ok &= compare_with_reference(args, q, tmp)

    log("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
