"""The port's entry points: one step of the flagship model, and a dry run
of every sharded path.

Twins of the repository's ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, (state, block))`` for the WBFM
  demodulation chain, ``fn(state, block)`` being
  :func:`rx_tools_tpu_torch.models.fmchain.fm_chain_step` under the ``-M
  wbfm`` preset planned for 100.3 MHz;
- :func:`dryrun_multichip` runs one step of each sharded path over an
  ``n_devices`` mesh on tiny shapes: the time-sharded FM chain three ways
  (raw DC block, the exact IIR carry, ``-E dc``), the channel-sharded
  polyphase filterbank over 2n channels and the hop-sharded power sweep
  over 2n hops.

Both run on the CUDA device unless ``device="cpu"`` (or
``RX_PLATFORM=cpu``) asks for the CPU.  Where the reference dry run asks
JAX for n virtual CPU devices, a mesh here takes distinct cards while the
machine has n of them and repeats the resolved device otherwise: one card
runs ``[cuda:0] * n``, the CPU ``[cpu] * n``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rx_tools_tpu_torch.device import local_devices, resolve_device
from rx_tools_tpu_torch.models import fmchain, pfb, powerscan
from rx_tools_tpu_torch.parallel import (channel_sharded_pfb_step,
                                         hop_sharded_sweep, make_mesh,
                                         shard_recording, time_sharded_fm)


#: the dry run's configurations, the reference's: the FM chain (three
#: variants), the PFB (its channel count set per call) and the sweep
_FM = dict(mode="fm", rate_in=170000, rate_out=170000, rate_out2=32000,
           downsample=6, custom_atan=1, deemph_a=7)
_FM_VARIANTS = (("fm_raw_dc", dict(dc_block_raw=True)), ("fm_exact", {}),
                ("fm_dc", dict(dc_block_audio=True)))
_PFB = dict(capture_rate=1_024_000, mode="fm", custom_atan=1, deemph_a=7,
            rate_out2=32_000)
_SWEEP = powerscan.PowerConfig(bin_e=5, downsample=1, buf_len=128)


def entry(device=None):
    cfg = fmchain.wbfm_preset()
    cfg, _, _ = fmchain.plan_capture(cfg, 100.3e6)
    n = fmchain.block_samples(cfg)
    state = fmchain.init_state(cfg, device)
    block = np.zeros(2 * n, np.int16)
    fn = functools.partial(fmchain.fm_chain_step, cfg)
    return fn, (state, block)


def _mesh_devices(n_devices: int, device=None) -> list[torch.device]:
    """``n_devices`` distinct cards while there are enough, else the
    resolved device ``n_devices`` times (with its card index)."""
    dev = resolve_device(device)
    local = local_devices(dev)
    if len(set(local)) >= n_devices:
        return local[:n_devices]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * n_devices


def _sync(devices) -> None:
    """Wait for every card of a mesh (the reference's
    ``block_until_ready``)."""
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _dryrun_outputs(n_devices: int, device=None) -> dict:
    """The dry run's outputs, the reference's steps on the same seeded
    inputs (``np.random.default_rng(0)``: the recording, then the PFB
    block, then the hop blocks):

    - ``fm_raw_dc``, ``fm_exact``, ``fm_dc``: ``(audio, n_valid, carry)``
      of ``time_sharded_fm`` with the raw DC block, as is, and with
      ``dc_block_audio``, 3 blocks a shard, warmup 1;
    - ``pfb``: ``(audio, n_valid)`` of one ``channel_sharded_pfb_step``
      over 2n channels;
    - ``sweep``: ``(avg, samples)`` of one ``hop_sharded_sweep`` over 2n
      hops."""
    n_dev = int(n_devices)
    devs = _mesh_devices(n_dev, device)
    home = devs[0]
    out = {}

    mesh_t = make_mesh(devices=devs, axis="t")
    cfgs = {name: fmchain.FmConfig(**_FM, **extra)
            for name, extra in _FM_VARIANTS}
    n = fmchain.block_samples(cfgs["fm_raw_dc"], target=96)
    blocks_per_shard = 3
    rng = np.random.default_rng(0)
    iq = rng.integers(-2000, 2000,
                      2 * n_dev * blocks_per_shard * n).astype(np.int16)
    sharded = shard_recording(iq, n_dev, n)
    for name, cfg in cfgs.items():
        out[name] = time_sharded_fm(cfg, sharded, mesh=mesh_t, warmup=1)
        _sync(devs)

    pc = pfb.PfbConfig(n_channels=2 * n_dev, **_PFB)
    pn = pfb.block_samples(pc, target=4096)
    block = rng.integers(-3000, 3000, 2 * pn).astype(np.int16)
    _, audio, n_valid = channel_sharded_pfb_step(
        pc, pfb.init_state(pc, home), block, make_mesh(devices=devs,
                                                       axis="c"))
    _sync(devs)
    out["pfb"] = (audio, n_valid)

    hops = 2 * n_dev
    hop_blocks = rng.integers(-3000, 3000,
                              (hops, _SWEEP.buf_len)).astype(np.int16)
    acc = hop_sharded_sweep(_SWEEP, powerscan.new_sweep_accum(hops, _SWEEP,
                                                             home),
                            hop_blocks, make_mesh(devices=devs, axis="h"))
    out["sweep"] = (acc.avg, acc.samples)
    _sync(devs)
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one step of every sharded path over an ``n_devices`` mesh on
    tiny shapes and check the shapes the reference checks: audio of
    ``n_devices`` shards, ``(n_devices, 3)`` IIR carries, 2n PFB channels
    and a ``(2n, bin_len)`` sweep average.  Returns ``None``; the outputs
    are :func:`_dryrun_outputs`'."""
    n_dev = int(n_devices)
    out = _dryrun_outputs(n_dev, device)
    _check(out["fm_raw_dc"][0].shape[0] == n_dev, "time-sharded audio rows")
    for name in ("fm_exact", "fm_dc"):
        _check(tuple(out[name][2].shape) == (n_dev, 3), f"{name} carry shape")
    _check(out["pfb"][0].shape[0] == 2 * n_dev, "PFB channels")
    _check(tuple(out["sweep"][0].shape) == (2 * n_dev, _SWEEP.bin_len),
           "sweep average shape")
