"""Envelope and product detectors (AM / USB / LSB).

Counterpart of :mod:`rx_tools_tpu.ops.demods`: ``am_demod``
(``src/rtl_fm.c:617-632``), ``usb_demod`` (``:634-644``), ``lsb_demod``
(``:646-656``) over ``(N, 2)`` I/Q; ``output_scale`` is the reference's
``(1<<15) / (128 * downsample)`` gain restore (``rtl_fm.c:988-992``).
"""

from __future__ import annotations

import torch


def am_demod(x: torch.Tensor, output_scale: float = 1.0) -> torch.Tensor:
    """Envelope: ``sqrt(I^2 + Q^2) * scale``; (N, 2) -> (N,)."""
    p = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
    return torch.sqrt(p) * float(output_scale)


def usb_demod(x: torch.Tensor, output_scale: float = 1.0) -> torch.Tensor:
    """Product detection, upper sideband: ``(I + Q) * scale``."""
    return (x[:, 0] + x[:, 1]) * float(output_scale)


def lsb_demod(x: torch.Tensor, output_scale: float = 1.0) -> torch.Tensor:
    """Product detection, lower sideband: ``(I - Q) * scale``."""
    return (x[:, 0] - x[:, 1]) * float(output_scale)
