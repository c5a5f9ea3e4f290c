"""Hop-axis sharding of rx_power sweeps.

Counterpart of :mod:`rx_tools_tpu.parallel.hopshard`.  The reference's
sweep is a serial loop over up to 10000 hops (``scanner``,
``src/rtl_power.c:670-772``), an embarrassingly parallel axis its own TODO
wanted to thread (``rtl_power.c:29-36``).  Here the hop rows split into
``mesh.size`` equal slices and every mesh device integrates its own rows
with the unsharded step (``powerscan.sweep_step``, or
``powerscan.int_sweep_powers`` for ``--int-fft``).  The float accumulators
stay on their devices between sweeps (:class:`ShardedSweepAccum`); they are
gathered only when read, at the CSV flush or a checkpoint.  No exchange
between shards happens in the steady state (``mesh.EXCHANGES`` is left
alone).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rx_tools_tpu_torch.models import powerscan
from rx_tools_tpu_torch.parallel.mesh import Mesh


def _rows(h: int, mesh: Mesh) -> int:
    if h % mesh.size:
        raise ValueError(f"{h} hops do not shard over {mesh.size} devices")
    return h // mesh.size


def shard_hop_blocks(blocks, mesh: Mesh) -> list[torch.Tensor]:
    """(H, L) hop read-blocks as ``mesh.size`` row slices, slice ``s`` on
    ``mesh.devices[s]`` (H divisible by the mesh size)."""
    per = _rows(blocks.shape[0], mesh)
    return [torch.as_tensor(blocks[s * per:(s + 1) * per]).to(dev)
            for s, dev in enumerate(mesh.devices)]


class ShardedSweepAccum(NamedTuple):
    """Float sweep accumulators split by hop rows, part ``s`` on mesh
    device ``s``.  ``avg`` and ``samples`` gather them onto the first
    part's device (the flush's read)."""
    parts: tuple[powerscan.SweepAccum, ...]

    @property
    def avg(self) -> torch.Tensor:
        dev = self.parts[0].avg.device
        return torch.cat([p.avg.to(dev) for p in self.parts])

    @property
    def samples(self) -> torch.Tensor:
        dev = self.parts[0].samples.device
        return torch.cat([p.samples.to(dev) for p in self.parts])

    def gathered(self) -> powerscan.SweepAccum:
        return powerscan.SweepAccum(self.avg, self.samples)


def shard_accum(acc, mesh: Mesh) -> ShardedSweepAccum:
    """Split (H, bins) accumulators by rows over ``mesh``."""
    if isinstance(acc, ShardedSweepAccum):
        return acc
    per = _rows(acc.avg.shape[0], mesh)
    return ShardedSweepAccum(tuple(
        powerscan.SweepAccum(
            torch.as_tensor(acc.avg[s * per:(s + 1) * per]).to(dev),
            torch.as_tensor(acc.samples[s * per:(s + 1) * per]).to(dev))
        for s, dev in enumerate(mesh.devices)))


def hop_sharded_sweep(cfg: powerscan.PowerConfig, acc, blocks,
                      mesh: Mesh) -> ShardedSweepAccum:
    """One sweep pass with hops sharded over ``mesh``: ``blocks`` (H,
    buf_len) int16, H divisible by the mesh size; ``acc`` a
    :class:`powerscan.SweepAccum` (split here) or the previous pass's
    :class:`ShardedSweepAccum` (its parts stay where they are)."""
    acc = shard_accum(acc, mesh)
    parts = shard_hop_blocks(blocks, mesh)
    return ShardedSweepAccum(tuple(
        powerscan.sweep_step(cfg, a, b) for a, b in zip(acc.parts, parts)))


def int_hop_sharded(cfg: powerscan.PowerConfig, blocks,
                    mesh: Mesh) -> torch.Tensor:
    """``--int-fft`` hop sharding: each mesh device runs the bit-exact
    integer scanner on its own hop rows; the (H, segs, bin_len) int32
    powers are gathered onto ``mesh.devices[0]`` (the CLI accumulates them
    into int64 on the host, as the reference CLI does).  Integer outputs
    are deterministic per hop, so sharded == unsharded bit for bit."""
    parts = shard_hop_blocks(blocks, mesh)
    dev0 = mesh.devices[0]
    return torch.cat([powerscan.int_sweep_powers(cfg, p).to(dev0)
                      for p in parts])
