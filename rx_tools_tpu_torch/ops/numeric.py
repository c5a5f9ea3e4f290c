"""Small numeric helpers shared by the ops."""

from __future__ import annotations

import functools

import numpy as np
import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE float division on every device.

    PyTorch's CUDA ``div`` by a host scalar multiplies by the reciprocal
    instead, which differs in the last ulp; dividing by a 0-dim tensor on
    ``x``'s own device keeps the division the reference performs."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def fp32_products() -> None:
    """Matrix products and convolutions in full float32 (TF32 off), the
    reference's ``Precision.HIGHEST``.  The package turns TF32 off at
    import; the models that multiply matrices call this again before each
    step, so a caller that switched TF32 on does not change their values."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=256)
def _cached(make_table, args, device: str) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(make_table(*args)),
                           device=device)


def device_const(make_table, *args, device: torch.device) -> torch.Tensor:
    """``make_table(*args)`` (a numpy table) as a tensor on ``device``,
    made and copied once per (function, args, device): a host-to-device
    copy on every call would wait for the device each time."""
    return _cached(make_table, args, str(device))
