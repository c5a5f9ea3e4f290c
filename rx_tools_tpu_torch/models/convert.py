"""Carry the models' states across packages as numpy arrays.

The reference package's state, fetched to the host (``jax.device_get``),
is a nest of NamedTuples of numpy arrays with the same field names as the
port's: :class:`~rx_tools_tpu_torch.models.fmchain.FmState`, the mixer
channelizer's ``ChannelizerState``/``ChannelizerStateTM`` and the PFB's
``PfbState``/``PfbStateTM``.  ``*_from_numpy`` turns it (or the dicts that
``*_to_numpy`` write) into the port's state on a device, and back.  The
round trip is lossless: dtypes and shapes are kept (``nco_num`` and the
resampler phase int32, ``sample_index`` an int32 scalar).  The channelizers'
prototype, DFT and mix matrices derive from the config and are not
carried.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models.channelizer import (ChannelizerState,
                                                   ChannelizerStateTM)
from rx_tools_tpu_torch.models.fmchain import FmState
from rx_tools_tpu_torch.models.pfb import PfbState, PfbStateTM

#: sub-state NamedTuple type of each nested state field
_NESTED = {
    "boxcar": ops.BoxcarState,
    "fifth": ops.FifthOrderState,
    "droop": ops.DroopState,
    "resamp": ops.ResampleState,
    "polyfir": ops.PolyFirState,
    "sincresamp": ops.SincResampleState,
}


def _fields(obj) -> Mapping:
    if isinstance(obj, Mapping):
        return obj
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a mapping or a NamedTuple, got {type(obj)}")


def _state_from_numpy(cls, d, device):
    dev = resolve_device(device)
    top = _fields(d)

    def leaf(v):
        return torch.as_tensor(np.array(v, copy=True), device=dev)

    kw = {}
    for name in cls._fields:
        v = top[name]
        sub = _NESTED.get(name)
        if sub is None:
            kw[name] = leaf(v)
        else:
            sv = _fields(v)
            kw[name] = sub(**{f: leaf(sv[f]) for f in sub._fields})
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """Any of the models' states as nested dicts of numpy arrays (host
    copies)."""
    out = {}
    for name, v in state._asdict().items():
        if name in _NESTED:
            out[name] = {f: t.detach().cpu().numpy()
                         for f, t in v._asdict().items()}
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def fm_state_from_numpy(d, device=None) -> FmState:
    """An :class:`FmState` on ``device`` from a nest of numpy arrays (a
    mapping or a NamedTuple per level, the reference's field names)."""
    return _state_from_numpy(FmState, d, device)


def channelizer_state_from_numpy(d, device=None) -> ChannelizerState:
    """The channel-major mixer's state on ``device``."""
    return _state_from_numpy(ChannelizerState, d, device)


def channelizer_state_tm_from_numpy(d, device=None) -> ChannelizerStateTM:
    """The time-major mixer's state on ``device``."""
    return _state_from_numpy(ChannelizerStateTM, d, device)


def pfb_state_from_numpy(d, device=None) -> PfbState:
    """The channel-major PFB's state on ``device``."""
    return _state_from_numpy(PfbState, d, device)


def pfb_state_tm_from_numpy(d, device=None) -> PfbStateTM:
    """The time-major PFB's state on ``device``."""
    return _state_from_numpy(PfbStateTM, d, device)


fm_state_to_numpy = state_to_numpy
