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
                                         (14, 100, 2, True)])
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
