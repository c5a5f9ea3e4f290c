"""The capture-head dispatch, the fs/4 masks, and the interleaved head (K3).

Counterpart of :mod:`rx_tools_tpu.ops.pallas_frontend`.  The capture-rate
hot path of the FM chain is

    int16 interleaved I/Q  ->  8-bit-range rescale  (rtl_fm.c:845-848)
                           ->  fs/4 derotation      (rtl_fm.c:309-327)
                           ->  boxcar decimate by D (rtl_fm.c:351-371)

:func:`capture_frontend_planar` is the head every chain engine calls: the
CUDA kernel (K1, ``ops.frontend_mxu.capture_frontend_mm_pallas``) for a
CUDA tensor, its integer-exact plain version for a CPU tensor.
:func:`capture_frontend_pallas` (K3) is the interleaved ``(N/D, 2)``
layout of the same kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SCALE = np.float32(128.0 / 32767.0)


@functools.lru_cache(maxsize=32)
def _fs4_decim_masks(d: int, rotate: bool):
    """(2D,) Re/Im masks in {+1, 0, -1} fusing rescale+rotate+decimate.

    The rotated-then-decimated output is ``z[k] = i^(Dk) * sum_j x[Dk+j] *
    i^j``; over the FLAT interleaved stream each element lands in exactly
    one of Re(z)/Im(z) with sign +/-1.
    """
    a = np.zeros(2 * d, np.float32)     # -> Re(z)
    b = np.zeros(2 * d, np.float32)     # -> Im(z)
    for j in range(d):
        m = (j & 3) if rotate else 0
        if m == 0:
            a[2 * j] = 1.0; b[2 * j + 1] = 1.0
        elif m == 1:                    # x * i: (I, Q) -> (-Q, I)
            b[2 * j] = 1.0; a[2 * j + 1] = -1.0
        elif m == 2:
            a[2 * j] = -1.0; b[2 * j + 1] = -1.0
        else:
            b[2 * j] = -1.0; a[2 * j + 1] = 1.0
    return a, b


def capture_frontend_planar(block_i16: torch.Tensor, downsample: int,
                            rotate: bool = True):
    """``(2N,) int16 -> ((N/D,), (N/D,)) float32`` planar I/Q — the
    production head of both chain engines (K1 on CUDA)."""
    from rx_tools_tpu_torch.ops import frontend_mxu
    return frontend_mxu.capture_frontend_mm_pallas(block_i16, downsample,
                                                   rotate)


def capture_frontend_jnp(block_i16: torch.Tensor, downsample: int,
                         rotate: bool = True):
    """``(2N,) int16 -> (N/D, 2) float32`` paired variant (same math)."""
    zi, zq = capture_frontend_planar(block_i16, downsample, rotate)
    return torch.stack([zi, zq], dim=-1)


def capture_frontend_pallas(block_i16: torch.Tensor, downsample: int,
                            rotate: bool = True, interpret: bool = False):
    """K3: ``(2N,) int16 -> (N/D, 2) float32`` interleaved capture head.

    The interleaved output layout of ``kernels/csrc/capture_head.cu``;
    counts its CUDA launches.  A CPU tensor runs the plain version;
    ``interpret=True`` (the reference's Pallas interpreter) raises
    ``ValueError``."""
    from rx_tools_tpu_torch.ops import frontend_mxu
    frontend_mxu._pallas_options("capture_frontend_pallas", interpret)
    if block_i16.device.type == "cpu":
        return frontend_mxu.capture_head_plain(block_i16, downsample, rotate,
                                               interleaved=True)
    out = frontend_mxu._launch_head(block_i16, downsample, rotate, True,
                                    "capture_frontend_pallas")
    capture_frontend_pallas.launches += 1
    return out


capture_frontend_pallas.launches = 0


def capture_frontend(block_i16: torch.Tensor, downsample: int,
                     rotate: bool = True):
    """Interleaved frontend dispatch: K3 on CUDA, the plain version on
    the CPU."""
    return capture_frontend_pallas(block_i16, downsample, rotate)
