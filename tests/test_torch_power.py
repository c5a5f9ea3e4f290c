"""rx_power's ops, planner and sweep model in the port against the reference
package on the same seeded inputs: the windows and the planner exactly,
the ``--int-fft`` tier bit for bit (and against the ``c_ref`` oracle), the
float tier at a stated tolerance.

Float tolerance (the FFTs of XLA and torch differ in the last ulps): every
accumulator within rtol 1e-4 plus an atol of 1e-6 x its hop's largest bin,
which covers near-empty bins such as the DC bin after the mean removal."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import c_ref
from rx_tools_tpu import ops as ref_ops
from rx_tools_tpu.models import power_plan as ref_plan
from rx_tools_tpu.models import powerscan as ref_scan
from rx_tools_tpu.ops import intfft as ref_intfft
from rx_tools_tpu.ops import spectrum as ref_sp
from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import power_plan, powerscan
from rx_tools_tpu_torch.ops import intfft, spectrum

torch.set_num_threads(2)

RTOL, ATOL_OF_PEAK = 1e-4, 1e-6


def assert_float_close(got, want):
    """The float tier's bound, hop by hop (last axis = bins)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim else want.reshape(1, 1)
    g2 = got.reshape(w2.shape)
    for g, w in zip(g2, w2):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_OF_PEAK * np.abs(w).max())


def _tone_blocks(rng, h, n, amp=0.4, noise=0.02, dc=0.0):
    """(h, 2n) int16 CS16 hops: a tone at a random bin per hop, noise and
    an optional DC offset, full-scale units like a source's reads."""
    t = np.arange(n)
    out = np.empty((h, 2 * n), np.int16)
    for i in range(h):
        f0 = rng.uniform(-0.45, 0.45)
        z = (amp * np.exp(2j * np.pi * f0 * t)
             + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             + dc)
        out[i, 0::2] = np.clip(np.round(z.real * 32767), -32768, 32767)
        out[i, 1::2] = np.clip(np.round(z.imag * 32767), -32768, 32767)
    return out


# ---------------------------------------------------------------------------
# windows and the planner: exact copies


@pytest.mark.parametrize("name", sorted(ref_ops.WINDOWS))
def test_windows_bitwise(name):
    for length in (2, 5, 64, 512, 2048):
        np.testing.assert_array_equal(ops.window(name, length),
                                      ref_ops.window(name, length))
        assert ops.window(name, length).dtype == np.float32
        np.testing.assert_array_equal(ops.window_coefs_int(name, length),
                                      ref_ops.window_coefs_int(name, length))
        np.testing.assert_array_equal(
            ops.window(name, length, np.float64),
            ref_ops.window(name, length, np.float64))


def _plan_fields(tunes):
    return [(t.freq, t.rate, t.bin_e, t.downsample, t.downsample_passes,
             t.crop, t.buf_len) for t in tunes]


@pytest.mark.parametrize("lo,hi,max_bin,crop,boxcar", [
    (88e6, 108e6, 125e3, 0.0, True),        # test_spectrum_golden goldens
    (100e6, 100.1e6, 1e3, 0.0, True),
    (100e6, 1e9, 1e6, 0.3, True),
    (100e6, 1e9, 12_500, 0.0, True),
    (99e6, 101e6, 1e3, 0.0, True),          # BASELINE config #4
    (100e6, 1e9, 10e3, 0.2, True),          # BASELINE config #5
    (100e6, 100.5e6, 1e3, 0.0, False),      # -F: power-of-2 passes
    (100e6, 110e6, 1e6, 0.0, True),         # giant bins
])
def test_plan_matches_reference(lo, hi, max_bin, crop, boxcar):
    got = power_plan.plan_sweep(lo, hi, max_bin, crop, boxcar=boxcar)
    want = ref_plan.plan_sweep(lo, hi, max_bin, crop, boxcar=boxcar)
    assert _plan_fields(got) == _plan_fields(want)
    assert [t.bin_len for t in got] == [t.bin_len for t in want]
    assert power_plan.describe_plan(got) == ref_plan.describe_plan(want)


def test_plan_random_ranges_match_reference():
    """The random plans of tests/test_fuzz_power.py:40: equal fields, or
    the same refusal."""
    rng = np.random.default_rng(41)
    compared = 0
    for _ in range(60):
        lo = int(rng.integers(1, 2000)) * 1_000_000
        span = max(int(rng.choice([1, 2, 5, 8, 20, 100, 400, 1500]))
                   * 1_000_000, 100_000)
        max_bin = float(rng.choice([1, 10, 100, 1_000, 10_000, 125_000,
                                    1_000_000, 2_000_000]))
        crop = float(rng.choice([0.0, 0.2, 0.5]))
        boxcar = bool(rng.integers(0, 2))
        try:
            want = ref_plan.plan_sweep(lo, lo + span, max_bin, crop, boxcar)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                power_plan.plan_sweep(lo, lo + span, max_bin, crop, boxcar)
            continue
        got = power_plan.plan_sweep(lo, lo + span, max_bin, crop, boxcar)
        assert _plan_fields(got) == _plan_fields(want)
        compared += 1
    assert compared > 30
    for name in ("MAXIMUM_RATE", "MINIMUM_RATE", "DEFAULT_BUF_LENGTH",
                 "MAX_TUNES"):
        assert getattr(power_plan, name) == getattr(ref_plan, name)


# ---------------------------------------------------------------------------
# --int-fft: bit for bit


@pytest.mark.parametrize("m", [0, 1, 5, 9, 11])
def test_int_tables_match_reference(m):
    np.testing.assert_array_equal(intfft._bitrev_perm(m),
                                  ref_intfft._bitrev_perm(m))
    if m:
        np.testing.assert_array_equal(intfft.sine_table_np(m),
                                      ref_intfft.sine_table_np(m))
        assert intfft.sine_table_np(m).tolist() == c_ref.sine_table(m)


@pytest.mark.parametrize("m", [1, 3, 6, 9])
def test_fix_fft_batch_bitwise(m):
    n = 1 << m
    rng = np.random.default_rng(m)
    re = rng.integers(-32768, 32768, (3, n)).astype(np.int32)
    im = rng.integers(-32768, 32768, (3, n)).astype(np.int32)
    gr, gi = intfft.fix_fft_batch(torch.from_numpy(re), torch.from_numpy(im),
                                  m)
    assert gr.dtype == gi.dtype == torch.int32
    wr, wi = ref_intfft.fix_fft_batch(jnp.asarray(re), jnp.asarray(im), m)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    iq = np.empty(2 * n, np.int64)
    iq[0::2], iq[1::2] = re[0], im[0]
    want = c_ref.fix_fft(list(iq), m)
    assert gr[0].tolist() == want[0::2] and gi[0].tolist() == want[1::2]


@pytest.mark.parametrize("ds", [1, 3, 4])
def test_boxcar_and_remove_dc_int_bitwise(ds):
    """Wrapping group sums and the truncating half-DC divisor (negative
    sums included) against the reference package."""
    rng = np.random.default_rng(ds)
    x = rng.integers(-32768, 32768, (4, 2 * 96 * ds)).astype(np.int32)
    x[1] = np.abs(x[1]) // 3 - 20000          # a large negative DC
    got = intfft.remove_dc_int(intfft.boxcar_decim_int(torch.from_numpy(x),
                                                       ds))
    want = ref_intfft.remove_dc_int(ref_intfft.boxcar_decim_int(
        jnp.asarray(x), ds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = x[1, : 2 * 96] if ds == 1 else None
    if row is not None:
        d = c_ref.remove_dc(list(row))
        d[1:] = c_ref.remove_dc(d[1:])
        assert got[1].tolist() == d


def _rand_int_hop(rng):
    """A random hop as tests/test_fuzz_power.py draws them: bin_e, ds,
    segments, window and an int16 block whose boxcar x window product
    stays in the reference's int16 contract."""
    bin_e = int(rng.integers(2, 10))
    ds = int(rng.choice([1, 1, 2, 4]))
    segs = int(rng.integers(1, 5))
    window = str(rng.choice(sorted(ref_ops.WINDOWS)))
    n = (1 << bin_e) * ds * segs
    t = np.arange(n)
    z = (24.0 / ds) * np.exp(2j * np.pi * rng.uniform(0, 0.5) * t) \
        + rng.normal(0, 1.0, n)
    iq = np.empty(2 * n, np.int16)
    iq[0::2], iq[1::2] = np.round(z.real), np.round(z.imag)
    return bin_e, ds, segs, window, iq


def test_int_hop_segments_bitwise_vs_reference_and_oracle():
    rng = np.random.default_rng(43)
    for trial in range(10):
        bin_e, ds, segs, window, iq = _rand_int_hop(rng)
        ctx = f"trial {trial}: bin_e={bin_e} ds={ds} segs={segs} {window}"
        win = ops.window_coefs_int(window, 1 << bin_e)
        got = intfft.int_hop_segments(torch.from_numpy(iq), torch.from_numpy(
            win), bin_e, ds)
        want = ref_intfft.int_hop_segments(jnp.asarray(iq), jnp.asarray(win),
                                           bin_e=bin_e, ds=ds)
        assert got.dtype == torch.int32, ctx
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=ctx)
        ref, samples = c_ref.scanner_segment(list(iq), bin_e, list(win),
                                             ds=ds)
        assert got.numpy().astype(np.int64).sum(axis=0).tolist() == ref, ctx
        assert samples == segs * ds


@pytest.mark.parametrize("window", ["rectangle", "hamming", "youssef"])
@pytest.mark.parametrize("bin_e,ds,h", [(6, 1, 5), (4, 3, 3), (9, 1, 2)])
def test_int_sweep_powers_bitwise(window, bin_e, ds, h):
    buf_len = 2 * (1 << bin_e) * ds * 3
    cfg = powerscan.PowerConfig(bin_e=bin_e, downsample=ds, window=window,
                                buf_len=buf_len)
    rcfg = ref_scan.PowerConfig(bin_e=bin_e, downsample=ds, window=window,
                                buf_len=buf_len)
    blocks = _tone_blocks(np.random.default_rng(bin_e + ds), h,
                          buf_len // 2, amp=0.3)
    got = powerscan.int_sweep_powers(cfg, blocks, "cpu")
    want = np.asarray(ref_scan.int_sweep_powers(rcfg, blocks))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor's own device is used
    again = powerscan.int_sweep_powers(cfg, torch.from_numpy(blocks))
    assert torch.equal(again, got)


@pytest.mark.parametrize("cfg,msg", [
    (dict(bin_e=6, boxcar=False, downsample=4, downsample_passes=2),
     "--int-fft supports the boxcar decimation path only (drop -F)"),
    (dict(bin_e=6, downsample=3, buf_len=16384),
     "--int-fft: buf_len not divisible by 2*downsample (partial-group "
     "boxcar tail unsupported)"),
    (dict(bin_e=11, buf_len=1 << 17),
     "--int-fft: hop too long for exact int32 sums"),
])
def test_int_sweep_powers_guards(cfg, msg):
    """The reference's three ValueError guards, word for word."""
    blocks = np.zeros((1, cfg.get("buf_len", 16384)), np.int16)
    with pytest.raises(ValueError) as got:
        powerscan.int_sweep_powers(powerscan.PowerConfig(**cfg), blocks,
                                   "cpu")
    with pytest.raises(ValueError) as want:
        ref_scan.int_sweep_powers(ref_scan.PowerConfig(**cfg), blocks)
    assert str(got.value) == str(want.value) == msg


def test_rms_power_int_exact():
    rng = np.random.default_rng(7)
    for dc in (0.0, 12.0, -40.0):
        iq = np.clip(rng.normal(dc, 40.0, 4096), -127, 127).astype(np.int16)
        blk = (iq.astype(np.int32) * 256).astype(np.int16)
        assert intfft.rms_power_int(blk) == ref_intfft.rms_power_int(blk)
        assert intfft.rms_power_int(iq) == c_ref.rms_power(list(iq))[0]


# ---------------------------------------------------------------------------
# the float tier at the stated tolerance


@pytest.mark.parametrize("window", ["rectangle", "hamming",
                                    "blackman-harris"])
@pytest.mark.parametrize("peak", [False, True])
def test_segmented_power_spectrum_close(window, peak):
    rng = np.random.default_rng(3)
    bin_e, segs = 6, 8
    x = rng.normal(0, 30.0, (segs, 1 << bin_e, 2)).astype(np.float32)
    x[..., 0] += 60 * np.cos(2 * np.pi * 10.5 / 64 * np.arange(64))
    win = ops.window(window, 1 << bin_e)
    avg0 = rng.uniform(0, 1e6, 1 << bin_e).astype(np.float32)
    ga, gs = spectrum.segmented_power_spectrum(
        torch.from_numpy(x), torch.from_numpy(win), torch.from_numpy(avg0),
        torch.tensor(5, dtype=torch.int32), 2, peak)
    wa, ws = ref_sp.segmented_power_spectrum(
        jnp.asarray(x), jnp.asarray(win), jnp.asarray(avg0), jnp.int32(5), 2,
        peak)
    assert ga.dtype == torch.float32 and gs.dtype == torch.int32
    assert int(gs) == int(ws) == 5 + segs * 2
    assert_float_close(ga.numpy(), wa)


def test_total_power_and_csv_quirks_match():
    rng = np.random.default_rng(5)
    x = rng.normal(3.0, 40.0, (4096, 2)).astype(np.float32)
    g = float(spectrum.total_power(torch.from_numpy(x)))
    w = float(ref_sp.total_power(jnp.asarray(x)))
    assert abs(g - w) <= RTOL * abs(w)
    avg = rng.uniform(1, 1e9, 32)
    np.testing.assert_array_equal(spectrum.fftshift_quirks(avg),
                                  ref_sp.fftshift_quirks(avg))
    np.testing.assert_array_equal(
        spectrum.fftshift_quirks(torch.from_numpy(avg)).numpy(),
        ref_sp.fftshift_quirks(avg))
    np.testing.assert_array_equal(spectrum.power_to_dbm(avg, 2.4e6, 64),
                                  ref_sp.power_to_dbm(avg, 2.4e6, 64))
    cfg = powerscan.PowerConfig(bin_e=5)
    for crop in (0.0, 0.25):
        got = powerscan.csv_row_values(avg, 32, cfg, 100e6, 1e6, crop)
        want = ref_scan.csv_row_values(avg, 32, ref_scan.PowerConfig(
            bin_e=5), 100e6, 1e6, crop)
        assert got == want


# -F 9 (fifth-order x 2 + droop), -P, bin_e = 0 (total power) and -P with
# it, the boxcar, and a zero input (exact zeros, -inf in the CSV)
HOP_CASES = {
    "hamming": dict(bin_e=6, window="hamming", buf_len=2 * 64 * 4),
    "boxcar-ds4": dict(bin_e=5, downsample=4, window="blackman",
                       buf_len=2 * 32 * 4 * 3),
    "F9": dict(bin_e=6, downsample=4, downsample_passes=2, boxcar=False,
               comp_fir_size=9, buf_len=2 * 64 * 4 * 4),
    "F0": dict(bin_e=5, downsample=8, downsample_passes=3, boxcar=False,
               buf_len=2 * 32 * 8 * 2),
    "P": dict(bin_e=5, peak_hold=True, window="bartlett",
              buf_len=2 * 32 * 6),
    "bin_e0": dict(bin_e=0, buf_len=4096),
    "bin_e0-P": dict(bin_e=0, peak_hold=True, buf_len=2048),
}


def _both_cfgs(case):
    kw = HOP_CASES[case]
    return powerscan.PowerConfig(**kw), ref_scan.PowerConfig(**kw)


@pytest.mark.parametrize("case", sorted(HOP_CASES))
def test_power_hop_step_close(case):
    cfg, rcfg = _both_cfgs(case)
    rng = np.random.default_rng(len(case))
    avg = torch.zeros(cfg.bin_len)
    samples = torch.zeros((), dtype=torch.int32)
    ravg, rsamples = jnp.zeros(cfg.bin_len, jnp.float32), jnp.int32(0)
    for dc in (0.0, 0.05, -0.1):                 # three reads integrated
        block = _tone_blocks(rng, 1, cfg.buf_len // 2, dc=dc)[0]
        avg, samples = powerscan.power_hop_step(cfg, avg, samples, block)
        ravg, rsamples = ref_scan.power_hop_step(rcfg, ravg, rsamples,
                                                 jnp.asarray(block))
    assert avg.dtype == torch.float32 and samples.dtype == torch.int32
    assert int(samples) == int(rsamples)
    assert_float_close(avg.numpy(), ravg)


@pytest.mark.parametrize("case", sorted(HOP_CASES))
def test_sweep_step_close(case):
    """All hops in one batched step against the reference's vmap, twice
    (accumulators carried), one hop silent: its exact zeros stay exact."""
    cfg, rcfg = _both_cfgs(case)
    h = 4
    rng = np.random.default_rng(7)
    acc = powerscan.new_sweep_accum(h, cfg, "cpu")
    racc = ref_scan.new_sweep_accum(h, rcfg)
    for _ in range(2):
        blocks = _tone_blocks(rng, h, cfg.buf_len // 2)
        blocks[2] = 0
        acc = powerscan.sweep_step(cfg, acc, blocks)
        racc = ref_scan.sweep_step(rcfg, racc, jnp.asarray(blocks))
    assert isinstance(acc, powerscan.SweepAccum)
    assert acc.avg.shape == (h, cfg.bin_len) and acc.avg.dtype == torch.float32
    np.testing.assert_array_equal(acc.samples.numpy(),
                                  np.asarray(racc.samples))
    assert_float_close(acc.avg.numpy(), racc.avg)
    assert not acc.avg[2].any() and not np.asarray(racc.avg)[2].any()
    # the batched step is the per-hop step, hop by hop
    for i in range(h):
        a, s = powerscan.power_hop_step(cfg, torch.zeros(cfg.bin_len),
                                        torch.zeros((), dtype=torch.int32),
                                        blocks[i])
        a2 = powerscan.sweep_step(cfg, powerscan.new_sweep_accum(
            h, cfg, "cpu"), blocks).avg[i]
        assert_float_close(a.numpy(), a2.numpy())


def test_new_sweep_accum_layout():
    cfg = powerscan.PowerConfig(bin_e=9)
    acc = powerscan.new_sweep_accum(402, cfg, "cpu")
    racc = ref_scan.new_sweep_accum(402, ref_scan.PowerConfig(bin_e=9))
    for a, b in zip(acc, racc):
        assert tuple(a.shape) == b.shape
        assert a.numpy().dtype == np.asarray(b).dtype
        assert not a.any()
