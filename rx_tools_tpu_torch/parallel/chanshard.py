"""Channel-axis sharding of the PFB channelizer.

Counterpart of :mod:`rx_tools_tpu.parallel.chanshard`.  Every channel's
demod tail is independent once the branch DFT has split the capture, so:

- the branch FIR (``pfb._fb_pre_mxu``) runs replicated, on every mesh
  device — the shared capture-rate work, cheaper than any exchange that
  would distribute it;
- shard ``s`` multiplies its own ``(2*D/n, 2D)`` row slice of the DFT
  matrix (its channels' Re rows, then their Im rows) against the shared
  branch output, in full float32 (TF32 off), which IS the channel
  partition;
- the batched demod tail (``channelizer.demod_tail_batch_planar``) runs on
  the shard's own channels with their state.

No exchange between shards in the steady state; the per-channel math is
the single-device step's, so results equal ``pfb.pfb_step`` (bit for bit
on the CPU, where a product's row slice gives the rows of the full
product).  ``rx_channels -n D -t N`` and multi-process channel division
run it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rx_tools_tpu_torch.models import channelizer as _chan
from rx_tools_tpu_torch.models import pfb
from rx_tools_tpu_torch.ops.numeric import device_const, fp32_products
from rx_tools_tpu_torch.ops.resample import ResampleState
from rx_tools_tpu_torch.parallel.mesh import Mesh


@functools.lru_cache(maxsize=32)
def _dft_slices(d: int, n_dev: int, lo: int = 0, hi: int | None = None
                ) -> np.ndarray:
    """(n_dev, 2*(hi-lo)/n, 2D) stacked per-shard row slices of the DFT
    matrix for channels [lo, hi): shard ``s`` gets the Re rows of its
    channels followed by their Im rows, so its product is ``[zi; zq]``
    of its channels."""
    hi = d if hi is None else hi
    m = pfb._dft_matrix(d)                       # (2D, 2D)
    dn = (hi - lo) // n_dev
    return np.stack([
        np.concatenate([m[lo + s * dn: lo + (s + 1) * dn],
                        m[d + lo + s * dn: d + lo + (s + 1) * dn]])
        for s in range(n_dev)])


def channel_sharded_pfb_step(cfg: pfb.PfbConfig, state: pfb.PfbState,
                             block, mesh: Mesh, channels=None):
    """One wideband block -> channel stack, channels sharded over ``mesh``.
    The contract of ``pfb.pfb_step`` (restricted to ``channels=(lo, hi)``
    when given: the per-channel state leaves then have ``hi-lo`` rows and
    the audio covers only those channels; the channel count must divide by
    the mesh size).  The state and outputs live on ``mesh.devices[0]``;
    each shard's slice moves to its device and back."""
    n_dev = mesh.size
    d = cfg.n_channels
    lo, hi = channels if channels is not None else (0, d)
    if (hi - lo) % n_dev:
        raise ValueError(
            f"{hi - lo} channels do not shard over {n_dev} devices")
    dn = (hi - lo) // n_dev
    fp32_products()
    home = state.tail.device
    dfts = {}
    outs = []
    tail_new = None
    for s, dev in enumerate(mesh.devices):
        if dev not in dfts:
            # the replicated branch FIR, once per distinct device
            new_tail, w = pfb._fb_pre_mxu(cfg, state.tail.to(dev), block)
            dfts[dev] = w
            if tail_new is None:
                tail_new = new_tail.to(home)
        w = dfts[dev]
        rows = device_const(_dft_slices, d, n_dev, lo, hi, device=dev)[s]
        ch = rows @ w
        sl = slice(s * dn, (s + 1) * dn)
        prev, davg, racc, rph, audio, nv = _chan.demod_tail_batch_planar(
            cfg, state.prev_iq[sl].to(dev), state.deemph_avg[sl].to(dev),
            state.resamp.acc[sl].to(dev), state.resamp.phase[sl].to(dev),
            ch[:dn], ch[dn:])
        outs.append((prev, davg, racc, rph, audio, nv))

    def cat(i):
        return torch.cat([o[i].to(home) for o in outs])

    return (pfb.PfbState(tail=tail_new, prev_iq=cat(0), deemph_avg=cat(1),
                         resamp=ResampleState(cat(2), cat(3))),
            cat(4), cat(5))
