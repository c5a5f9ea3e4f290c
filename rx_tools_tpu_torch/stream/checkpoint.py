"""Checkpoint/resume for streaming state.

Counterpart of :mod:`rx_tools_tpu.stream.checkpoint`, in the same file
format, so a checkpoint written by either package resumes in the other:
an ``.npz`` of the state's leaves as ``leaf_{i}`` plus a JSON ``__meta__``
dict, written atomically (a sibling temp file, then ``os.replace``).  The
leaves are stored in ``jax.tree.flatten`` order — depth first over the
NamedTuple fields — and carry no names: interop is by that order alone,
with every leaf's dtype and shape (``boxcar.phase`` and ``squelch_hits``
are int32 0-d arrays in both packages).  A leaf may also be a numpy array
(rx_power's ``--int-fft`` accumulators are host int64 arrays in both
packages); it is restored as a numpy array.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


_LEAF = (torch.Tensor, np.ndarray)


def tree_leaves(tree) -> list:
    """The tensors (or numpy arrays) of a nest of NamedTuples (a chain
    state, sweep accumulators), in ``jax.tree.flatten`` order."""
    if isinstance(tree, _LEAF):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    raise TypeError(f"not a state nest: {type(tree)}")


def _rebuild(template, leaves):
    """``template`` with its leaves taken in order from ``leaves``."""
    if isinstance(template, _LEAF):
        return next(leaves)
    return type(template)(*(_rebuild(v, leaves) for v in template))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def _like(arr: np.ndarray, t):
    """``arr`` as the template leaf ``t``: its dtype, shape and device."""
    arr = np.asarray(arr).reshape(tuple(t.shape))
    if isinstance(t, np.ndarray):
        return arr.astype(t.dtype)
    return torch.as_tensor(arr).to(device=t.device, dtype=t.dtype)


def save_checkpoint(path: str, state, meta: dict | None = None) -> None:
    """Atomic: a kill mid-save leaves the previous checkpoint intact."""
    arrays = {f"leaf_{i}": _to_numpy(x)
              for i, x in enumerate(tree_leaves(state))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def read_meta(path: str) -> dict:
    """Just the meta dict: a cheap check before restoring the state."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")


def load_checkpoint(path: str, state_like):
    """Restore a state saved by :func:`save_checkpoint` (either package).

    ``state_like``: a template with the same structure (e.g. a fresh
    ``init_state(cfg, device)``); each leaf is cast to the template leaf's
    dtype and shape and placed on its device (a numpy template leaf gives
    a numpy array).  Raises ``KeyError`` for a missing leaf and
    ``ValueError`` for a shape that does not fit.  Returns
    ``(state, meta)``."""
    template = tree_leaves(state_like)
    with np.load(path) as z:
        loaded = [z[f"leaf_{i}"] for i in range(len(template))]
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
    restored = [_like(arr, t) for arr, t in zip(loaded, template)]
    return _rebuild(state_like, iter(restored)), meta
