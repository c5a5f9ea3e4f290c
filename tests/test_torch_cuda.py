"""The CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc; skips otherwise.  On a machine with a card
(and no JAX), run: ``python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from rx_tools_tpu_torch.ops import frontend_mxu, fused_frontend
from rx_tools_tpu_torch.ops import pallas_frontend


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(dev, n_int16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-32768, 32767, (n_int16,), generator=g, device=dev,
                         dtype=torch.int32).to(torch.int16)


@pytest.mark.parametrize("d,k,rot", [(14, 221184, True), (6, 21888, True),
                                     (8, 33, True), (6, 35, False),
                                     (126, 300, True), (500, 40, True),
                                     (1, 1001, True)])
def test_capture_head_bitwise(cuda, d, k, rot):
    x = _x(cuda, 2 * d * k, seed=d + k)
    zi, zq = frontend_mxu.capture_head_plain(x, d, rot)
    before = frontend_mxu.capture_frontend_mm_pallas.launches
    g1 = frontend_mxu.capture_frontend_mm_pallas(x, d, rot)
    g4 = frontend_mxu.capture_frontend_mm_pallas2(x, d, rot)
    g3 = pallas_frontend.capture_frontend_pallas(x, d, rot)
    torch.cuda.synchronize()
    assert frontend_mxu.capture_frontend_mm_pallas.launches == before + 1
    for got in (g1, g4):
        assert torch.equal(got[0], zi) and torch.equal(got[1], zq)
    assert torch.equal(g3, torch.stack([zi, zq], dim=-1))


@pytest.mark.parametrize("d,kpb,m,rot", [(14, 18432, 12, True),
                                         (6, 1368, 16, True),
                                         (6, 1000, 3, False),
                                         (14, 100, 2, True),
                                         (14, 18432, 1, True),
                                         (14, 18432, 48, True),
                                         # more tiles a block than the ring
                                         # holds partials: summed from memory
                                         (1, 100000, 2, True)])
def test_fused_matches_plain(cuda, d, kpb, m, rot):
    x = _x(cuda, 2 * d * kpb * m, seed=kpb)
    prev = torch.tensor([3.0, -2.0], device=cuda)
    before = fused_frontend.fused_capture_fm.launches
    pg, dg, lg = fused_frontend.fused_capture_fm_demod(prev, x, d, kpb, rot)
    pp, dp, lp = fused_frontend.fused_capture_fm_plain(prev, x, d, kpb, rot)
    torch.cuda.synchronize()
    assert fused_frontend.fused_capture_fm.launches == before + 1
    # tests/test_fused_frontend.py:46-53
    np.testing.assert_allclose(dg.cpu().numpy(), dp.cpu().numpy(), atol=5e-2)
    np.testing.assert_allclose(lg.cpu().numpy(), lp.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(pg.cpu().numpy(), pp.cpu().numpy(), atol=1e-3)
    assert torch.equal(dg, dp)      # 0 ulp, seams included
    # reruns give identical levels: no float atomics
    _, _, lg2 = fused_frontend.fused_capture_fm_demod(prev, x, d, kpb, rot)
    assert torch.equal(lg, lg2)


def test_wrappers_validate(cuda):
    x = _x(cuda, 2 * 6 * 64)
    with pytest.raises(ValueError):
        frontend_mxu.capture_frontend_mm_pallas(x[1:-1], 6)     # misaligned
    with pytest.raises(TypeError):
        frontend_mxu.capture_frontend_mm_pallas(x.to(torch.int32), 6)
    with pytest.raises(ValueError):
        frontend_mxu.capture_frontend_mm_pallas(x[:-2], 6)      # ragged


def _offset_view(dev, n_int16, off_int16, seed):
    """``n_int16`` values starting ``2 * off_int16`` bytes past a 16-byte
    boundary (the kernels copy the 16-byte superset of each tile)."""
    base = _x(dev, n_int16 + 8, seed=seed)
    assert base.data_ptr() % 16 == 0
    return base[off_int16:off_int16 + n_int16]


@pytest.mark.parametrize("off", [2, 4, 6])
@pytest.mark.parametrize("d,k", [(14, 221184), (6, 1001), (7, 333)])
def test_capture_head_offset_views(cuda, d, k, off):
    x = _offset_view(cuda, 2 * d * k, off, seed=k + off)
    assert x.data_ptr() % 16 == 2 * off
    zi, zq = frontend_mxu.capture_head_plain(x, d)
    g1 = frontend_mxu.capture_frontend_mm_pallas(x, d)
    g3 = pallas_frontend.capture_frontend_pallas(x, d)
    torch.cuda.synchronize()
    assert torch.equal(g1[0], zi) and torch.equal(g1[1], zq)
    assert torch.equal(g3, torch.stack([zi, zq], dim=-1))


@pytest.mark.parametrize("off", [2, 4, 6])
@pytest.mark.parametrize("d,kpb,m", [(14, 18432, 12), (6, 1000, 3)])
def test_fused_offset_views(cuda, d, kpb, m, off):
    x = _offset_view(cuda, 2 * d * kpb * m, off, seed=kpb + off)
    prev = torch.tensor([1.5, 0.5], device=cuda)
    dg, lg, last = fused_frontend.fused_capture_fm(prev, x, d, kpb)
    pp, dp, lp = fused_frontend.fused_capture_fm_plain(prev, x, d, kpb)
    torch.cuda.synchronize()
    assert torch.equal(dg, dp)
    np.testing.assert_allclose(lg.cpu().numpy(), lp.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(last, pp)


def test_fused_ticket_resets_between_launches(cuda):
    """Launches of different m in a row: each finds the counter at zero
    (the last CTA resets it), so the levels repeat bit for bit."""
    d, kpb = 14, 18432
    x = _x(cuda, 2 * d * kpb * 48, seed=11)
    prev = torch.zeros(2, device=cuda)
    _, lv48, _ = fused_frontend.fused_capture_fm(prev, x, d, kpb)
    _, lv1, _ = fused_frontend.fused_capture_fm(prev, x[:2 * d * kpb], d,
                                                kpb)
    _, lv12, _ = fused_frontend.fused_capture_fm(
        prev, x[:2 * d * kpb * 12], d, kpb)
    _, lv48b, _ = fused_frontend.fused_capture_fm(prev, x, d, kpb)
    torch.cuda.synchronize()
    assert torch.equal(lv48, lv48b)
    assert torch.equal(lv1, lv48[:1]) and torch.equal(lv12, lv48[:12])


@pytest.mark.parametrize("grids", [(1, None), (7, 1000)])
def test_results_do_not_depend_on_grid(cuda, grids):
    d, kpb, m = 14, 18432, 12
    x = _x(cuda, 2 * d * kpb * m, seed=5)
    prev = torch.tensor([3.0, -2.0], device=cuda)
    outs = [fused_frontend.fused_capture_fm(prev, x, d, kpb, grid=g)
            for g in grids]
    heads = [frontend_mxu._launch_head(x, d, True, False, "grid", grid=g)
             for g in grids]
    torch.cuda.synchronize()
    (d0, l0, p0), (d1, l1, p1) = outs
    assert torch.equal(d0, d1) and torch.equal(l0, l1) and torch.equal(p0, p1)
    assert all(torch.equal(a, b) for a, b in zip(*heads))



# the reference's plain matrix forms of the head (library products on the
# card) at BASELINE config #1's chunk: 12 blocks of 258048 samples, D = 14
CFG1_D, CFG1_K = 14, 221184


@pytest.mark.parametrize("name", ["capture_frontend_mm_i8",
                                  "capture_frontend_mm_i16",
                                  "capture_frontend_mm_i16_2"])
def test_exact_head_forms_on_card(cuda, name):
    d = CFG1_D
    x = _x(cuda, 2 * d * CFG1_K, seed=41)
    zi, zq = frontend_mxu.capture_head_plain(x, d)
    gi, gq = getattr(frontend_mxu, name)(x, d)
    torch.cuda.synchronize()
    assert gi.device.type == "cuda"
    assert torch.equal(gi, zi) and torch.equal(gq, zq)


@pytest.mark.parametrize("name", ["capture_frontend_mm",
                                  "capture_frontend_t2",
                                  "capture_frontend_conv"])
def test_float_head_forms_on_card(cuda, tf32_on, name):
    """With TF32 allowed in the process each form still multiplies in full
    float32 (tests/test_frontend_mxu.py:29's bound)."""
    d = CFG1_D
    x = _x(cuda, 2 * d * CFG1_K, seed=42)
    zi, zq = frontend_mxu.capture_head_plain(x, d)
    gi, gq = getattr(frontend_mxu, name)(x, d)
    for got, want in ((gi, zi), (gq, zq)):
        assert got.device.type == "cuda" and got.shape == want.shape
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=5e-3)


def test_bf16_head_probe_on_card(cuda):
    """The bf16 class (tests/test_frontend_mxu.py:187-198) on that test's
    input, and at config #1 the card's probe against the CPU's."""
    rng = np.random.default_rng(31)
    d = CFG1_D
    x = torch.from_numpy(
        rng.integers(-2000, 2000, 2 * d * 32 * 24).astype(np.int16)).to(cuda)
    for got, plain in zip(frontend_mxu.capture_frontend_mm_bf16(x, d),
                          frontend_mxu.capture_head_plain(x, d)):
        assert got.dtype == torch.float32
        assert float(((got - plain).abs() / (plain.abs() + 1)).max()) < 0.05
    x = _x(cuda, 2 * d * CFG1_K, seed=43)
    for got, want in zip(frontend_mxu.capture_frontend_mm_bf16(x, d),
                         frontend_mxu.capture_frontend_mm_bf16(x.cpu(), d)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=2e-5, atol=5e-3)


@pytest.mark.parametrize("d,k,rot", [(5, 2 * 49, False),   # P = 2, k = 20
                                     (6, 2 * 5, False),    # P = 2, 5 rows
                                     (14, 32 * 3, True),   # 3 rows
                                     (14, CFG1_K, True)])  # no padding
def test_mm_i8_pads_to_int_mm(cuda, monkeypatch, d, k, rot):
    """Shapes outside ``torch._int_mm``'s rules are padded with zeros: the
    result stays bitwise and both products still run on ``_int_mm``."""
    calls = []
    int_mm = torch._int_mm

    def counting(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", counting)
    x = _x(cuda, 2 * d * k, seed=d + k)
    zi, zq = frontend_mxu.capture_head_plain(x, d, rot)
    gi, gq = frontend_mxu.capture_frontend_mm_i8(x, d, rot)
    torch.cuda.synchronize()
    assert torch.equal(gi, zi) and torch.equal(gq, zq)
    assert len(calls) == 2
    for (m, kk), (kb, n) in calls:
        assert m > 16 and kk % 8 == 0 and n % 8 == 0 and kk == kb


@pytest.mark.parametrize("a", [13, 8, 1])
@pytest.mark.parametrize("n", [1368, 1, 9000])
def test_int_deemph_bitwise(cuda, a, n):
    """The integer de-emphasis kernel against its host walk: negative
    samples and starting averages, odd and even a, one-sample blocks and
    blocks longer than one shared-memory tile."""
    from rx_tools_tpu_torch.ops import intaudio
    rng = np.random.default_rng(n + a)
    x = torch.as_tensor(rng.integers(-32768, 32767, n))
    for avg0 in (0, -1234, 40000, 70000, -(2 ** 31 + 5)):
        avg = torch.tensor(avg0, dtype=torch.int64)
        before = intaudio.deemph_int.launches
        ga, gy = intaudio.deemph_int(avg.to(cuda), x.to(cuda), a)
        pa, py = intaudio.deemph_int_plain(avg, x, a)
        torch.cuda.synchronize()
        assert intaudio.deemph_int.launches == before + 1
        assert int(ga) == int(pa)
        assert torch.equal(gy.cpu(), py)
    # one-sample calls carry like one call over the block
    avg = torch.tensor(-77, dtype=torch.int64, device=cuda)
    ys = []
    for v in x[:40].tolist():
        avg, y1 = intaudio.deemph_int(avg, torch.tensor([v], device=cuda), a)
        ys.append(y1)
    _, y_all = intaudio.deemph_int_plain(torch.tensor(-77), x[:40], a)
    assert torch.equal(torch.cat(ys).cpu(), y_all)


def _deemph_case(cuda, avg0, x, a, schedule=None):
    """One kernel call (the plan's segments, or ``schedule = (seg_len,
    halo)``) against the plain walk: (launches, fallback)."""
    from rx_tools_tpu_torch.kernels import plan
    from rx_tools_tpu_torch.ops import intaudio
    avg = torch.tensor(avg0, dtype=torch.int64)
    xt = torch.as_tensor(x, dtype=torch.int64)
    fb = torch.full((2,), -1, dtype=torch.int32, device=cuda)
    p = plan.deemph_plan(xt.numel(), a)
    seg_len, halo = schedule or (p.seg_len, p.halo)
    before = intaudio.deemph_int.launches
    ga, gy = intaudio._launch_deemph(avg.to(cuda), xt.to(cuda), a, seg_len,
                                     halo, fallback=fb)
    pa, py = intaudio.deemph_int_plain(avg, xt, a)
    torch.cuda.synchronize()
    assert int(ga) == int(pa), (avg0, a, x.size)
    assert torch.equal(gy.cpu(), py), (avg0, a, x.size)
    return intaudio.deemph_int.launches - before, fb.tolist()


@pytest.mark.parametrize("n_label", ["1", "L-1", "L", "L+1", "1368", "9000"])
@pytest.mark.parametrize("a", [1, 2, 8, 13, 75, 240])
@pytest.mark.parametrize("kind", ["noise", "tone", "silence", "constant",
                                  "square", "step"])
def test_int_deemph_input_classes(cuda, kind, a, n_label):
    """The kernel bit for bit against its host walk over the input classes,
    constants and lengths of the CPU schedule tests (one launch a call),
    and its fallback counts equal to the schedule model's."""
    from oracles import deemph_schedule as sched
    from rx_tools_tpu_torch.kernels import plan
    seg_len = plan.deemph_plan(1368, a).seg_len
    n = {"L-1": seg_len - 1, "L": seg_len, "L+1": seg_len + 1}.get(
        n_label) or int(n_label)
    x = sched.signal(kind, n, seed=n + a)
    for avg0 in (0, -1234, 40000, 70000, -(2 ** 31 + 5)):
        launches, fb = _deemph_case(cuda, avg0, x, a)
        assert launches == 1
        assert fb == list(sched.walk(avg0, x, a)[2:])


@pytest.mark.parametrize("seg_len,halo", [(16, 0), (16, 3), (17, 40),
                                          (50, 0), (33, 200), (4096, 0)])
@pytest.mark.parametrize("kind", ["noise", "tone", "step"])
def test_int_deemph_forced_segments(cuda, kind, seg_len, halo):
    """Short halos leave walks that meet inside their segment or never:
    the ordered fallback on the card, across tiles too."""
    from oracles import deemph_schedule as sched
    for n in (300, 9000):
        x = sched.signal(kind, n, seed=seg_len + n)
        for avg0 in (0, 40000, -(2 ** 31 + 5)):
            _, fb = _deemph_case(cuda, avg0, x, 13, schedule=(seg_len, halo))
            assert fb == list(sched.walk(avg0, x, 13, seg_len, halo)[2:])


@pytest.mark.parametrize("above", [True, False])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("a", [1, 13, 2 ** 31 - 1])
def test_int_deemph_at_the_32_bit_limit(cuda, a, offset, above):
    """``hi - lo + a/2`` at 2**31 - 1 (the 32-bit walk's last range) and
    2**31 (the 64-bit walk's first), the first step as wide as the range:
    bit for bit, one launch, and with short segments the fallback counts
    of the walk the model takes there."""
    from oracles import deemph_schedule as sched
    avg0, x = sched.edge_case(a, offset, above)
    for schedule in (None, (16, 0)):
        launches, fb = _deemph_case(cuda, avg0, x, a, schedule)
        assert launches == 1
        assert fb == list(sched.walk(avg0, x, a, *(schedule or ()))[2:])


def test_int_deemph_int64_extremes(cuda):
    """The 64-bit walk is exact for any int64 pair, like the host walk."""
    x = np.array([2 ** 62, -(2 ** 62), 2 ** 63 - 1, -(2 ** 63), 5, -7, 0],
                 np.int64)
    for avg0 in (-(2 ** 63), 2 ** 63 - 1, 0):
        for a in (1, 13, 2 ** 31 - 1):
            _deemph_case(cuda, avg0, x, a)


def test_int_deemph_validates(cuda):
    from rx_tools_tpu_torch.ops import intaudio
    avg = torch.zeros((), dtype=torch.int64, device=cuda)
    x = torch.zeros(1368, dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError):           # 1368 segments of one
        intaudio._launch_deemph(avg, x, 13, 1, 0)
    with pytest.raises(ValueError):
        intaudio._launch_deemph(avg, x, 13, 11, 231, fallback=torch.zeros(
            2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        intaudio.deemph_int(avg, x, 0)
    with pytest.raises(TypeError):
        intaudio.deemph_int(avg, x.to(torch.int32), 13)


@pytest.fixture
def tf32_on():
    """TF32 allowed for convolutions and matrix products (cuDNN's
    documented default) for one test."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def test_fir_decimate_card_matches_cpu(cuda, tf32_on):
    """The polyphase FIR on the card against the CPU with TF32 allowed in
    the process: no convolution or matrix product runs, so the card keeps
    float32 (tests/test_polyfir.py:22's bound)."""
    from rx_tools_tpu_torch.ops import polyfir
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((8208, 2)).astype(np.float32))
    taps = torch.as_tensor(polyfir.design_lowpass(64, 1 / 6))
    st = polyfir.PolyFirState.init(64)
    cs, cy = polyfir.fir_decimate(st, x, taps, 6)
    gs, gy = polyfir.fir_decimate(
        polyfir.PolyFirState(st.tail.to(cuda)), x.to(cuda), taps.to(cuda), 6)
    np.testing.assert_allclose(gy.cpu().numpy(), cy.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(gs.tail.cpu(), cs.tail)


@pytest.mark.parametrize("window", ["rectangle", "hamming", "blackman-harris"])
@pytest.mark.parametrize("bin_e,ds,h,buf_len", [
    (9, 1, 402, 16384),           # BASELINE config #5's sweep
    (11, 1, 2, 2 * 2048 * 64),    # config #4's 2048 bins, longer reads
    (6, 4, 5, 2 * 64 * 4 * 8),    # boxcar decimation
])
def test_sweep_step_card_matches_cpu(cuda, window, bin_e, ds, h, buf_len):
    """rx_power's float sweep (cuFFT) on the card against the CPU, at the
    float tier's bound (rtol 1e-4, atol 1e-6 x the hop's peak)."""
    from rx_tools_tpu_torch.models import powerscan
    cfg = powerscan.PowerConfig(bin_e=bin_e, downsample=ds, window=window,
                                buf_len=buf_len)
    rng = np.random.default_rng(bin_e + h)
    blocks = rng.integers(-9000, 9000, (h, buf_len)).astype(np.int16)
    blocks[:, 0::2] += (8000 * np.cos(0.3 * np.arange(buf_len // 2))
                        ).astype(np.int16)
    acc = powerscan.new_sweep_accum(h, cfg, cuda)
    cpu = powerscan.new_sweep_accum(h, cfg, "cpu")
    for _ in range(2):
        acc = powerscan.sweep_step(cfg, acc, blocks)
        cpu = powerscan.sweep_step(cfg, cpu, blocks)
    assert acc.avg.device.type == "cuda"
    assert torch.equal(acc.samples.cpu(), cpu.samples)
    got, want = acc.avg.cpu().numpy(), cpu.avg.numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("window", ["rectangle", "hamming", "youssef"])
@pytest.mark.parametrize("bin_e,ds,h,buf_len", [
    (9, 1, 402, 16384),           # BASELINE config #5's sweep
    (11, 1, 4, 2 * 2048 * 8),     # 2048 bins, 8 segments a hop
    (5, 3, 6, 2 * 32 * 3 * 10),   # wrapping boxcar groups
])
def test_int_sweep_powers_card_bitwise(cuda, window, bin_e, ds, h, buf_len):
    """The --int-fft tier on the card is the CPU's bit for bit."""
    from rx_tools_tpu_torch.models import powerscan
    cfg = powerscan.PowerConfig(bin_e=bin_e, downsample=ds, window=window,
                                buf_len=buf_len)
    rng = np.random.default_rng(bin_e * ds)
    blocks = rng.integers(-32768, 32767, (h, buf_len)).astype(np.int16)
    got = powerscan.int_sweep_powers(cfg, blocks, cuda)
    want = powerscan.int_sweep_powers(cfg, blocks, "cpu")
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def _codec_inputs():
    rng = np.random.default_rng(12)
    all16 = np.arange(-32768, 32768, dtype=np.int16)
    u8 = np.arange(256, dtype=np.uint8)
    return {
        "cs16_to_cs8": all16, "cs16_to_cu8": all16, "cs16_to_cf32": all16,
        "cs16_rescale8": all16, "cs16_to_cs12": all16,
        "cu8_to_cs16": u8, "cs8_to_cs16": u8.view(np.int8),
        "cs12_to_cs16": rng.integers(0, 256, 3 * 40000, dtype=np.uint8),
        "cf32_to_cs16": np.concatenate([
            (rng.standard_normal(100000) * 0.6).astype(np.float32),
            ((np.arange(-500, 500) + 0.5) / np.float32(32767.0)).astype(
                np.float32),
            np.array([1.5, -1.5, 1.0, -1.0, 0.0], np.float32)]),
    }


@pytest.mark.parametrize("name", sorted(_codec_inputs()))
def test_tensor_codecs_card_bitwise(cuda, name, monkeypatch):
    """The wire-format codecs on CUDA tensors are the NumPy path's bit for
    bit (division IEEE on the card, integer stores wrapped), over all of
    int16 and uint8 where the codec takes them."""
    from rx_tools_tpu_torch import native
    from rx_tools_tpu_torch.iq import formats
    monkeypatch.setattr(native, "_LIB", None)     # numpy arrays: NumPy path
    monkeypatch.setattr(native, "_TRIED", True)
    x = _codec_inputs()[name]
    fn = getattr(formats, name)
    got = fn(torch.from_numpy(x.copy()).to(cuda))
    want = fn(x)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _fm_scene(fs, n, offsets, seed=3, amp=40, gain=64):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    z = np.zeros(n, np.complex128)
    for off in offsets:
        au = np.sin(2 * np.pi * (700 + off % 997) * t / fs)
        z += amp * np.exp(1j * (2 * np.pi * off * t / fs
                                + 2 * np.pi * 12e3 * np.cumsum(au) / fs))
    z += rng.normal(0, 0.5, n) + 1j * rng.normal(0, 0.5, n)
    iq = np.empty(2 * n, np.int16)
    iq[0::2] = np.round(z.real * gain)
    iq[1::2] = np.round(z.imag * gain)
    return iq


def _scaled_close(got, want, tol):
    want = want.cpu().numpy().astype(np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.cpu().numpy() / scale, want / scale,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("engine", ["tmaj", "cm"])
@pytest.mark.parametrize("kind", ["mixer", "pfb"])
def test_channelizers_card_match_cpu(cuda, tf32_on, kind, engine):
    """Both engines of both channelizers on the card against the port on
    the CPU over 3 chained blocks, with TF32 allowed in the process (the
    steps switch it off): audio and float state at the engines' bounds
    (tests/test_channelizer.py:119, tests/test_pfb.py:174), counts, NCO
    numerators and resampler phases exact."""
    from rx_tools_tpu_torch.models import channelizer, convert, pfb
    fs = 2_400_000
    if kind == "mixer":
        offs = (-600_000.0, -150_000.0, 37_000.0, 420_000.0)
        cfg = channelizer.ChannelizerConfig(
            capture_rate=fs, offsets=offs, downsample=16, mode="fm",
            custom_atan=1, deemph_a=7, rate_out2=32_000)
        n = channelizer.block_samples(cfg, target=131072)
        tol = 5e-4
        if engine == "tmaj":
            init, step = channelizer.init_state_tmaj, \
                channelizer.channelize_step_tmaj
        else:
            init, step = channelizer.init_state, channelizer.channelize_step
    else:
        offs = (-300_000.0, 37_500.0, 412_500.0)
        cfg = pfb.PfbConfig(capture_rate=fs, n_channels=64, mode="fm",
                            custom_atan=1, deemph_a=7, rate_out2=32_000)
        n = pfb.block_samples(cfg, target=524288)
        tol = 2e-4
        init, step = ((pfb.init_state_tmaj, pfb.pfb_step_tmaj)
                      if engine == "tmaj" else (pfb.init_state, pfb.pfb_step))
    iq = _fm_scene(fs, 3 * n, offs)
    sg, sc = init(cfg, cuda), init(cfg, "cpu")
    for b in range(3):
        blk = iq[b * 2 * n: (b + 1) * 2 * n]
        sg, ag, ng = step(cfg, sg, blk)
        sc, ac, nc = step(cfg, sc, blk)
        assert ag.device.type == "cuda"
        assert torch.equal(ng.cpu(), nc)
        _scaled_close(ag, ac, tol)
        got, want = convert.state_to_numpy(sg), convert.state_to_numpy(sc)
        for k, w in want.items():
            for kk, ww in (w.items() if isinstance(w, dict) else [(k, w)]):
                gg = got[k][kk] if isinstance(w, dict) else got[k]
                if np.issubdtype(ww.dtype, np.integer):
                    np.testing.assert_array_equal(gg, ww)
                else:
                    _scaled_close(torch.as_tensor(gg), torch.as_tensor(ww),
                                  tol)


@pytest.mark.parametrize("kind", ["mixer", "pfb"])
def test_scan_blocks_bitwise_per_block_on_card(cuda, kind):
    """The chunked steps (``*_scan_blocks_tmaj``) give per-block stepping's
    bits on the card."""
    from rx_tools_tpu_torch.models import channelizer, pfb
    fs = 2_400_000
    if kind == "mixer":
        cfg = channelizer.ChannelizerConfig(
            capture_rate=fs, offsets=(-150_000.0, 420_000.0), downsample=16,
            mode="fm", custom_atan=1, deemph_a=7, rate_out2=32_000)
        n = channelizer.block_samples(cfg, target=131072)
        init, step = channelizer.init_state_tmaj, \
            channelizer.channelize_step_tmaj
        scan = channelizer.channelize_scan_blocks_tmaj
    else:
        cfg = pfb.PfbConfig(capture_rate=fs, n_channels=64, mode="fm",
                            custom_atan=1, deemph_a=7, rate_out2=32_000)
        n = pfb.block_samples(cfg, target=131072)
        init, step, scan = (pfb.init_state_tmaj, pfb.pfb_step_tmaj,
                            pfb.pfb_scan_blocks_tmaj)
    blocks = _fm_scene(fs, 4 * n, (-150_000, 420_000)).reshape(4, 2 * n)
    st_s, a_s, nv_s = scan(cfg, init(cfg, cuda), blocks)
    st = init(cfg, cuda)
    for i in range(4):
        st, a, nv = step(cfg, st, blocks[i])
        assert torch.equal(a, a_s[i]) and torch.equal(nv, nv_s[i])


@pytest.mark.parametrize("fast,slow", [(37500, 32000), (150000, 32000),
                                       (48000, 32000)])
def test_batch_resampler_forms_on_card(cuda, fast, slow):
    """On the card the batch resampler takes the periodic-mask form; it
    matches the prefix-sum form on the same card (tests/test_batch_tail.py:
    60-84's bound) and the CPU's result."""
    from rx_tools_tpu_torch import ops
    from rx_tools_tpu_torch.ops import resample as rs
    rng = np.random.default_rng(51)
    c = 8
    st_p = rs.ResampleState(torch.zeros(c, device=cuda),
                            torch.zeros(c, dtype=torch.int32, device=cuda))
    st_g, st_c = st_p, rs.ResampleState(torch.zeros(c),
                                        torch.zeros(c, dtype=torch.int32))
    assert rs.periodic_eligible(fast, slow, cuda)
    for _ in range(3):
        x = torch.as_tensor(rng.normal(0, 5000, (c, 1024)).astype(np.float32))
        st_p, yp, nvp = ops.resample_rational_batch(st_p, x.to(cuda), fast,
                                                    slow)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rs, "periodic_eligible", lambda *a: False)
            st_g, yg, nvg = ops.resample_rational_batch(st_g, x.to(cuda),
                                                        fast, slow)
        st_c, yc, nvc = ops.resample_rational_batch(st_c, x, fast, slow)
        assert int(nvp) == int(nvg) == int(nvc)
        for y, acc in ((yg, st_g.acc), (yc, st_c.acc)):
            np.testing.assert_allclose(yp.cpu().numpy(), y.cpu().numpy(),
                                       rtol=1e-4, atol=0.5)
            np.testing.assert_allclose(st_p.acc.cpu().numpy(),
                                       acc.cpu().numpy(), rtol=1e-4, atol=0.5)
        assert torch.equal(st_p.phase.cpu(), st_c.phase)


@pytest.mark.parametrize("dc", [False, True])
def test_time_sharded_on_card(cuda, tf32_on, dc):
    """``time_sharded_fm`` on ``[cuda] * 4`` (the one card runs the four
    shards in turn): a first super-chunk and a continuation against the
    unsharded scan on the card (same counts, tests/test_parallel.py:60's
    rtol 1e-4 / atol 0.1) and against the same calls on the CPU."""
    from rx_tools_tpu_torch.models import fmchain
    from rx_tools_tpu_torch.parallel import make_mesh, time_sharded_fm
    from rx_tools_tpu_torch.parallel.timeshard import resampler_modulus
    from rx_tools_tpu_torch.stream.scan import scan_fm_blocks, stack_blocks
    s_n, m, warmup = 4, 4, 2
    cfg = fmchain.FmConfig(mode="fm", rate_in=170000, rate_out=170000,
                           rate_out2=32000, downsample=6, custom_atan=1,
                           deemph_a=7, dc_block_audio=dc)
    n = fmchain.block_samples(cfg, target=8192)
    rng = np.random.default_rng(4)
    blocks = stack_blocks(rng.integers(-3000, 3000, 2 * 2 * s_n * m * n)
                          .astype(np.int16), n)
    fmod = resampler_modulus(cfg)

    def sharded(devs):
        mesh = make_mesh(devices=devs)
        a1, nv1, c1 = time_sharded_fm(cfg, blocks[: s_n * m].reshape(
            s_n, m, -1), mesh=mesh, warmup=warmup)
        a2, nv2, _ = time_sharded_fm(
            cfg, blocks[s_n * m:].reshape(s_n, m, -1), mesh=mesh,
            warmup=warmup, cont=True, halo0=blocks[s_n * m - warmup: s_n * m],
            block_offset_mod=(s_n * m) % fmod, iir_carry=c1[-1])
        a = torch.cat([a1.reshape(s_n * m, -1), a2.reshape(s_n * m, -1)])
        nv = torch.cat([nv1.reshape(-1), nv2.reshape(-1)])
        assert a.device.type == devs[0].type
        return a.cpu().numpy(), nv.cpu().numpy()

    def flat(a, nv):
        return np.concatenate([a[i, : nv[i]] for i in range(len(nv))])

    got, got_nv = sharded([cuda] * s_n)
    cpu, cpu_nv = sharded([torch.device("cpu")] * s_n)
    _, ref, ref_nv, _ = scan_fm_blocks(cfg, fmchain.init_state(cfg, cuda),
                                       blocks)
    ref, ref_nv = ref.cpu().numpy(), ref_nv.cpu().numpy()
    np.testing.assert_array_equal(got_nv, ref_nv)
    np.testing.assert_array_equal(got_nv, cpu_nv)
    np.testing.assert_allclose(flat(got, got_nv), flat(ref, ref_nv),
                               rtol=1e-4, atol=0.1)
    np.testing.assert_allclose(flat(got, got_nv), flat(cpu, cpu_nv),
                               rtol=1e-4, atol=0.1)


def test_hop_sharded_on_card(cuda):
    """Hop sharding on ``[cuda] * 2`` at BASELINE config #5's sweep shape:
    float avg at rtol 1e-6 with samples equal to the unsharded step on the
    card; ``--int-fft`` bit for bit."""
    from rx_tools_tpu_torch.models import powerscan
    from rx_tools_tpu_torch.parallel import hop_sharded_sweep, make_mesh
    from rx_tools_tpu_torch.parallel.hopshard import int_hop_sharded
    cfg = powerscan.PowerConfig(bin_e=9, buf_len=16384)
    mesh = make_mesh(devices=[cuda] * 2, axis="h")
    rng = np.random.default_rng(9)
    acc_s = acc_u = powerscan.new_sweep_accum(402, cfg, cuda)
    for _ in range(2):
        blocks = rng.integers(-20000, 20000, (402, 16384)).astype(np.int16)
        acc_s = hop_sharded_sweep(cfg, acc_s, blocks, mesh)
        acc_u = powerscan.sweep_step(cfg, acc_u, blocks)
    assert all(p.avg.device.type == cuda.type for p in acc_s.parts)
    np.testing.assert_allclose(acc_s.avg.cpu().numpy(),
                               acc_u.avg.cpu().numpy(), rtol=1e-6)
    assert torch.equal(acc_s.samples, acc_u.samples)
    assert torch.equal(int_hop_sharded(cfg, blocks, mesh),
                       powerscan.int_sweep_powers(cfg, blocks, cuda))


@pytest.mark.parametrize("shards", [2, 4])
def test_channel_sharded_pfb_on_card(cuda, tf32_on, shards):
    """Channel sharding on ``[cuda] * k`` at D = 64 against ``pfb_step`` on
    the card over 3 chained blocks, with TF32 allowed in the process (the
    step switches it off): counts and resampler phases exact, audio and
    float state at the PFB bound (tests/test_pfb.py:174)."""
    from rx_tools_tpu_torch.models import pfb
    from rx_tools_tpu_torch.parallel import channel_sharded_pfb_step, make_mesh
    fs = 2_400_000
    cfg = pfb.PfbConfig(capture_rate=fs, n_channels=64, mode="fm",
                        custom_atan=1, deemph_a=7, rate_out2=32_000)
    n = pfb.block_samples(cfg, target=131072)
    iq = _fm_scene(fs, 3 * n, (-300_000.0, 37_500.0, 412_500.0))
    mesh = make_mesh(devices=[cuda] * shards, axis="c")
    st_s, st_u = pfb.init_state(cfg, cuda), pfb.init_state(cfg, cuda)
    for b in range(3):
        blk = iq[b * 2 * n: (b + 1) * 2 * n]
        st_s, a_s, nv_s = channel_sharded_pfb_step(cfg, st_s, blk, mesh)
        st_u, a_u, nv_u = pfb.pfb_step(cfg, st_u, blk)
        assert a_s.device.type == cuda.type
        assert torch.equal(nv_s, nv_u)
        _scaled_close(a_s, a_u, 2e-4)
    assert torch.equal(st_s.resamp.phase, st_u.resamp.phase)
    for got, want in ((st_s.tail, st_u.tail), (st_s.prev_iq, st_u.prev_iq),
                      (st_s.deemph_avg, st_u.deemph_avg),
                      (st_s.resamp.acc, st_u.resamp.acc)):
        _scaled_close(got, want, 2e-4)
