"""DSP ops on torch tensors.

Each op is a plain function over float32 tensors (planar ``(K,)`` I/Q
streams, ``(N, 2)`` I/Q blocks or ``(N,)`` real audio), with cross-block
memory passed explicitly as a small carried state (a NamedTuple of
tensors) — the same contract as :mod:`rx_tools_tpu.ops`.  The capture-rate
stages of the boxcar path are CUDA kernels (``frontend_mxu``,
``pallas_frontend``, ``fused_frontend``), and so is the integer tier's
de-emphasis (``intaudio``).  The channelizers' batched tail ops
(``fm_discriminate_batch*``, ``deemph_filter(..., axis=-1)``,
``resample_rational_batch``) take a ``(C, M)`` channel stack.  rx_power's ops (``windows``, ``spectrum``,
``intfft``) are plain torch: the float tier's FFT is ``torch.fft`` (cuFFT
on the card), the ``--int-fft`` tier int32 arithmetic.
"""

from rx_tools_tpu_torch.ops.cic import CIC_9_TABLES, cic_9_taps
from rx_tools_tpu_torch.ops.fir import (
    BoxcarState, FifthOrderState, DroopState, boxcar_decimate,
    fifth_order_decimate, fifth_order_cascade, droop_fir, low_pass_simple,
)
from rx_tools_tpu_torch.ops.polyfir import (
    PolyFirState, design_lowpass, fir_decimate,
)
from rx_tools_tpu_torch.ops.rotate import rotate_fs4, rotate_fs4_int16
from rx_tools_tpu_torch.ops.demods import am_demod, usb_demod, lsb_demod
from rx_tools_tpu_torch.ops.discriminators import (
    polar_discriminant, fast_atan2, polar_disc_fast, polar_disc_lut,
    esbensen_disc, fm_discriminate, fm_discriminate_planar, disc_mode,
    fm_discriminate_batch, fm_discriminate_batch_planar,
    DISC_STD, DISC_FAST, DISC_LUT, DISC_ALE,
)
from rx_tools_tpu_torch.ops.filters import (
    deemph_filter, deemph_alpha, deemph_blocks, dc_block_audio,
    dc_block_raw, rms_level, rms_level_planar, mad_level,
)
from rx_tools_tpu_torch.ops.pallas_frontend import (
    capture_frontend, capture_frontend_pallas, capture_frontend_jnp,
    capture_frontend_planar,
)
from rx_tools_tpu_torch.ops.resample import (
    resample_divisible, resample_rational, resample_rational_batch,
    resample_sinc, ResampleState, SincResampleState,
)
from rx_tools_tpu_torch.ops.windows import window, window_coefs_int, WINDOWS
from rx_tools_tpu_torch.ops.spectrum import (
    segmented_power_spectrum, remove_dc, total_power, fftshift_quirks,
    power_to_dbm,
)

__all__ = [k for k in dir() if not k.startswith("_")]
