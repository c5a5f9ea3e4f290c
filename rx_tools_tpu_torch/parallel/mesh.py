"""Device meshes: the scaling axes of the port.

Counterpart of :mod:`rx_tools_tpu.parallel.mesh`.  The reference's TODO
wished for "threading... multiple dongles... multiple FFT workers"
(``src/rtl_power.c:29-36``); here the axes are first-class:

- ``t`` (time): a long I/Q stream split into time shards, the carried
  filter state handed across shard seams as halos (``timeshard``);
- ``h`` (hops): rx_power's frequency hops, independent between retunes
  (``hopshard``);
- ``c`` (channels): the PFB's channel axis (``chanshard``).

A :class:`Mesh` is a tuple of ``torch.device`` entries plus an axis name,
and shard ``s`` runs on ``devices[s]``.  A device may repeat: a mesh of
eight ``cpu`` entries stands for the reference tests' 8 virtual CPU
devices, and ``[cuda:0] * 4`` lets one card run four shards in turn
through the same halo and gather code a machine with four cards runs.
Across processes (``multihost.global_mesh``) every entry also names the
rank that owns it; a process runs only its own entries.

``EXCHANGES`` counts the cross-shard exchanges the sharded functions make
(the reference tests count collectives in the compiled program instead):
a time-sharded call makes one halo exchange, plus one gather on the exact
path; hop and channel sharding make none.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import torch

from rx_tools_tpu_torch.device import local_devices, resolve_device

#: exchanges between shards, by kind ("halo", "gather", "output")
EXCHANGES: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class Mesh:
    """One mesh axis over ``devices``; ``ranks[s]`` is the process that owns
    entry ``s`` (all 0 in a one-process job)."""
    devices: tuple[torch.device, ...]
    axis: str = "t"
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # a CUDA entry without CUDA raises here, never later on a shard
        object.__setattr__(self, "devices",
                           tuple(resolve_device(d) for d in self.devices))
        if self.ranks is None:
            object.__setattr__(self, "ranks", (0,) * len(self.devices))
        elif len(self.ranks) != len(self.devices):
            raise ValueError("one rank per mesh entry")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self, rank: int = 0) -> list[int]:
        """The entries ``rank`` owns, in mesh order."""
        return [s for s, r in enumerate(self.ranks) if r == rank]


def make_mesh(n_devices: int | None = None, axis: str = "t",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: this
    process's devices, ``device.local_devices()``)."""
    devs = local_devices() if devices is None else list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis)


def local_mesh(axis: str = "t") -> Mesh:
    """Mesh over this process's devices only."""
    return Mesh(tuple(local_devices()), axis)
