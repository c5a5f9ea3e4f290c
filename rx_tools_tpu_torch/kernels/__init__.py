"""Hand-written CUDA kernels for Hopper and their ctypes bindings.

The wrappers that launch them live in the modules of their counterparts
(``ops/frontend_mxu.py`` for the capture head, ``ops/fused_frontend.py`` for
the fused front); this package builds the libraries (:mod:`.build`) and
declares the C signatures.  Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes

import torch

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_I, _F = ctypes.c_int, ctypes.c_float

_SIGNATURES = {
    "capture_head": {
        # x, out_a, out_b, k_total, d, rotate, interleaved, scale, stream
        "rx_capture_head": [_P, _P, _P, _LL, _I, _I, _I, _F, _P],
    },
    "fused_capture_fm": {
        "rx_fused_tile": [],
        # x, prev_iq, d_out, partials, levels, last, n_blocks, k_per_block,
        # d, rotate, scale, stream
        "rx_fused_capture_fm": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F,
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
