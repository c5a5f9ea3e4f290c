"""Hand-written CUDA kernels for Hopper and their ctypes bindings.

The wrappers that launch them live in the modules of their counterparts
(``ops/frontend_mxu.py`` for the capture head, ``ops/fused_frontend.py`` for
the fused front, ``ops/intaudio.py`` for the integer de-emphasis); this
package builds the libraries (:mod:`.build`),
declares the C signatures, plans the kernels' tiles (:mod:`.plan`) and
sizes their grid to one resident wave (:func:`grid`).  Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
non-zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_I, _F = ctypes.c_int, ctypes.c_float

_SIGNATURES = {
    "capture_head": {
        # x, out_a, out_b, k_total, d, rotate, interleaved, scale, rows,
        # stages, stage_bytes, grid, stream
        "rx_capture_head": [_P, _P, _P, _LL, _I, _I, _I, _F, _I, _I, _I, _I,
                            _P],
        # rows, threads, smem -> CTAs resident per SM
        "rx_capture_head_ctas_per_sm": [_I, _I, _I],
    },
    "fused_capture_fm": {
        # x, prev_iq, d_out, partials, levels, last, counter, n_blocks,
        # k_per_block, d, rotate, scale, rows, threads, stages, stage_bytes,
        # grid, stream
        "rx_fused_capture_fm": [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                _F, _I, _I, _I, _I, _I, _P],
        "rx_fused_capture_fm_ctas_per_sm": [_I, _I, _I],
    },
    "int_deemph": {
        # x, y, avg, fallback, n, deemph_a, magic, shift, seg_len, halo,
        # stream
        "rx_int_deemph": [_P, _P, _P, _P, _LL, _LL, ctypes.c_uint, _I, _I, _I,
                          _P],
    },
}

_bound: dict[str, ctypes.CDLL] = {}


def lib(name: str) -> ctypes.CDLL:
    """The library ``name`` with argtypes/restype declared (builds it at
    first use)."""
    handle = _bound.get(name)
    if handle is None:
        from rx_tools_tpu_torch.kernels import build
        handle = build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _bound[name] = handle
    return handle


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def grid(p, n_tiles: int, device: torch.device) -> int:
    """CTAs to launch for ``n_tiles`` tiles of plan ``p`` (a
    :class:`.plan.TilePlan`) on ``device``: one resident wave, as many
    CTAs as fit on all its SMs at once (the kernel's registers and shared
    memory, as the CUDA occupancy calculator counts them), never more than
    tiles."""
    from rx_tools_tpu_torch.kernels import plan
    index = torch.cuda._get_device_index(device, optional=True)
    return plan.grid(n_tiles, _sm_count(index),
                     _ctas_per_sm(p.kernel, p.rows, p.threads, p.smem, index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(name: str, rows: int, threads: int, smem: int,
                 index: int) -> int:
    with torch.cuda.device(index):
        n = getattr(lib(name), f"rx_{name}_ctas_per_sm")(rows, threads,
                                                          smem)
    if n <= 0:
        raise RuntimeError(f"{name}: {threads} threads with {smem} B of "
                           "shared memory do not fit on an SM")
    return n


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda_int16(x: torch.Tensor, what: str) -> None:
    """Validate an int16 CS16 input for a kernel: on CUDA, contiguous,
    even length, 4-byte aligned (the kernels load I/Q pairs as short2)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: kernel input must be a CUDA tensor")
    if x.dtype != torch.int16:
        raise TypeError(f"{what}: expected int16 CS16, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D int16 tensor")
    if x.numel() % 2 or x.data_ptr() % 4:
        raise ValueError(f"{what}: I/Q pairs must be whole and 4-byte aligned")
