"""DSP ops on torch tensors.

Each op is a plain function over float32 tensors (planar ``(K,)`` I/Q
streams, or ``(N,)`` real audio), with cross-block memory passed
explicitly as a small carried state (a NamedTuple of tensors) — the same
contract as :mod:`rx_tools_tpu.ops`.  The capture-rate stages are CUDA
kernels (``frontend_mxu``, ``pallas_frontend``, ``fused_frontend``).
"""

from rx_tools_tpu_torch.ops.fir import (
    BoxcarState, FifthOrderState, DroopState, low_pass_simple,
)
from rx_tools_tpu_torch.ops.polyfir import PolyFirState
from rx_tools_tpu_torch.ops.discriminators import (
    polar_discriminant, fast_atan2, polar_disc_fast, polar_disc_lut,
    esbensen_disc, fm_discriminate, fm_discriminate_planar, disc_mode,
    DISC_STD, DISC_FAST, DISC_LUT, DISC_ALE,
)
from rx_tools_tpu_torch.ops.filters import (
    deemph_filter, deemph_alpha, deemph_blocks, dc_block_audio,
    rms_level_planar,
)
from rx_tools_tpu_torch.ops.pallas_frontend import (
    capture_frontend, capture_frontend_pallas, capture_frontend_jnp,
    capture_frontend_planar,
)
from rx_tools_tpu_torch.ops.resample import (
    resample_rational, ResampleState, SincResampleState,
)

__all__ = [k for k in dir() if not k.startswith("_")]
