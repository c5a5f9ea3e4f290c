"""rx_tools_tpu_torch — the rx_tools software radio in PyTorch on CUDA.

The PyTorch twin of :mod:`rx_tools_tpu`, laid out module for module
(``ops/``, ``models/``, ``stream/``, ``iq/``, ``utils/``, ``apps/``), with
the capture-rate kernels written by hand in CUDA C++ for Hopper
(``kernels/csrc``).  Everything else runs as plain torch ops.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"`` or ``RX_PLATFORM=cpu``); on the CPU every kernel wrapper
runs its plain PyTorch version instead (see :mod:`.device`).

Float32 stays float32: the de-emphasis triangular scan and the resampler
prefix sums are matrix products whose reference runs at
``Precision.HIGHEST``, so TF32 is switched off for this process here.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rx_tools_tpu_torch.utils import units  # noqa: F401,E402
