"""Device resolution: CUDA unless the caller asks for the CPU.

``RX_PLATFORM=cpu`` (the variable the JAX CLIs honour) or an explicit
``device="cpu"`` selects the CPU; every kernel wrapper then runs its plain
PyTorch version.  Without a CUDA device and without such a request the
entry points raise: the port never drops to the CPU silently.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``device`` if given, else ``RX_PLATFORM``
    (``cpu`` or ``cuda``), else ``cuda``.  Raises when CUDA is wanted and
    absent."""
    if device is None:
        plat = os.environ.get("RX_PLATFORM", "").strip().lower()
        device = "cpu" if plat == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rx_tools_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' or set RX_PLATFORM=cpu to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def local_devices(device: str | torch.device | None = None
                  ) -> list[torch.device]:
    """This process's devices, the ones a mesh may span: every visible
    CUDA card (``torch.cuda.device_count()``), or on a CPU request
    ``JAX_NUM_CPU_DEVICES`` entries of ``cpu`` (default 1) — the variable
    of the reference package's ``jax_num_cpu_devices`` option, so one
    environment gives both packages the same device count."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    n = os.environ.get("JAX_NUM_CPU_DEVICES", "").strip()
    return [torch.device("cpu")] * max(1, int(n) if n else 1)
