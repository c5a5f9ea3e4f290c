"""fs/4 frequency translation ("rotate by 90 degrees").

Counterpart of :mod:`rx_tools_tpu.ops.rotate`.  rx_fm captures ``freq +
capture_rate/4`` to keep the signal away from the tuner's DC spike
(``src/rtl_fm.c:980-984``) and undoes the offset digitally by multiplying
sample ``n`` by ``i**n`` — pure sign/swap on interleaved samples
(``rotate16_90``, ``src/rtl_fm.c:309-327``):

  sample 0: ( I,  Q)     sample 1: (-Q,  I)
  sample 2: (-I, -Q)     sample 3: ( Q, -I)

over ``(N, 2)`` blocks with N a multiple of 4 (the chain's block sizes are).
"""

from __future__ import annotations

import torch


def _rotate(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-2] % 4:
        raise ValueError("rotate_fs4 needs N % 4 == 0")
    v = x.reshape(-1, 4, 2)
    i, q = v[..., 0], v[..., 1]
    re = torch.stack([i[:, 0], -q[:, 1], -i[:, 2], q[:, 3]], dim=1)
    im = torch.stack([q[:, 0], i[:, 1], -q[:, 2], -i[:, 3]], dim=1)
    return torch.stack([re, im], dim=-1).reshape(x.shape)


def rotate_fs4_int16(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact int16 variant (negation wraps like the C int16 store)."""
    return _rotate(x.to(torch.int16))


def rotate_fs4(x: torch.Tensor) -> torch.Tensor:
    """Any-dtype variant (float32 on the chain's stateful heads, int64 in
    the integer tier)."""
    return _rotate(x)
