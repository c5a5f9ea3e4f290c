"""Carry an :class:`FmState` across packages as numpy arrays.

The reference package's state, fetched to the host (``jax.device_get``),
is a nest of NamedTuples of numpy arrays with the same field names as
:class:`~rx_tools_tpu_torch.models.fmchain.FmState`;
:func:`fm_state_from_numpy` turns it (or the dicts that
:func:`fm_state_to_numpy` writes) into the port's state on a device, and
back.  The round trip is lossless: dtypes and shapes are kept.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.device import resolve_device
from rx_tools_tpu_torch.models.fmchain import FmState

#: sub-state NamedTuple type of each nested FmState field
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


def fm_state_from_numpy(d, device=None) -> FmState:
    """An :class:`FmState` on ``device`` from a nest of numpy arrays (a
    mapping or a NamedTuple per level, the reference's field names)."""
    dev = resolve_device(device)
    top = _fields(d)

    def leaf(v):
        return torch.as_tensor(np.array(v, copy=True), device=dev)

    kw = {}
    for name in FmState._fields:
        v = top[name]
        sub = _NESTED.get(name)
        if sub is None:
            kw[name] = leaf(v)
        else:
            sv = _fields(v)
            kw[name] = sub(**{f: leaf(sv[f]) for f in sub._fields})
    return FmState(**kw)


def fm_state_to_numpy(state: FmState) -> dict:
    """The state as nested dicts of numpy arrays (host copies)."""
    out = {}
    for name, v in state._asdict().items():
        if name in _NESTED:
            out[name] = {f: t.detach().cpu().numpy()
                         for f, t in v._asdict().items()}
        else:
            out[name] = v.detach().cpu().numpy()
    return out
