"""CUDA graphs of the time-major channelizer steps.

A time-major step, ``(cfg, state, block) -> (state, audio, n_valid)``,
launches ~150 small kernels; on the card its time goes to the host's
enqueue, not to the device.  :func:`graphed` gives such a pure step a
cache of captured CUDA graphs, so that on a CUDA state a call replays one
graph of the whole step.

- **The key** (:func:`graph_key`): the config (a frozen dataclass), the
  block's and each state tensor's shape and dtype, the device, and the
  TF32 flags as the step module's own ``fp32_products`` binding leaves
  them; a caller that replaces that binding gets graphs of its own.
- **Capture**: the first call with a key warms up on a side stream,
  captures into a private memory pool and replays; later calls replay.
  A capture that fails raises.
- **Inputs** are copied into the graph's static tensors.  The graph ends
  by writing its new state into its static inputs, so a state tensor is
  not copied when it is the very tensor the last replay returned,
  unchanged since: the ~6 copy launches a step this saves are worth 6 %
  of both channel benchmarks' rates on an H100.
- **Outputs** are clones of the graph's static outputs: a result a caller
  holds is never overwritten by a later call.
- **Constants**: the tables the step reads through
  ``ops.numeric.device_const`` live as long as the graph.

CPU tensors run the step itself.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch
from torch.utils import _pytree as pytree

from rx_tools_tpu_torch.models.fmchain import as_block
from rx_tools_tpu_torch.ops.numeric import holding_consts

#: graphs a step keeps; the least recently used goes
MAX_KEYS = 16


def graph_key(step, cfg, state, block: torch.Tensor) -> tuple:
    """What a capture of ``step(cfg, state, block)`` depends on (``step``
    undecorated).  Calls the step module's ``fp32_products`` first, as
    the step does."""
    step.__globals__["fp32_products"]()
    leaves = pytree.tree_leaves(state)
    return (cfg, tuple(block.shape), block.dtype,
            tuple((tuple(t.shape), t.dtype) for t in leaves),
            leaves[0].device, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class StepGraph:
    """One captured step: the graph, its static inputs and outputs, the
    tables it reads, and the state tensors its last replay returned."""

    def __init__(self, step, cfg, state, block: torch.Tensor):
        self.block = block.clone()
        self.inputs = [t.clone() for t in pytree.tree_leaves(state)]
        static = pytree.tree_unflatten(self.inputs,
                                       pytree.tree_structure(state))
        side = torch.cuda.Stream(block.device)
        side.wait_stream(torch.cuda.current_stream(block.device))
        with torch.cuda.stream(side):       # lazy set-up, cuBLAS workspace
            step(cfg, static, self.block)
        self.graph = torch.cuda.CUDAGraph()
        with holding_consts() as self.consts, torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            out = step(cfg, static, self.block)
            for i, o in zip(self.inputs, pytree.tree_leaves(out[0])):
                if o.data_ptr() != i.data_ptr():    # not passed through
                    i.copy_(o)
        self.outputs, self.spec = pytree.tree_flatten(out)
        self.last: list = []

    def __call__(self, state, block: torch.Tensor):
        self.block.copy_(block)
        last = self.last or [(None, None)] * len(self.inputs)
        for i, t, (t0, v0) in zip(self.inputs, pytree.tree_leaves(state),
                                  last):
            if t is not t0 or t._version != v0:
                i.copy_(t)
        self.graph.replay()
        result = pytree.tree_unflatten([o.clone() for o in self.outputs],
                                       self.spec)
        self.last = [(t, t._version) for t in pytree.tree_leaves(result[0])]
        return result


def graphed(step):
    """``step`` with a cache of CUDA graphs (this module's docstring); the
    step itself stays reachable as ``__wrapped__``, and ``captures``
    counts the graphs made."""
    graphs: OrderedDict = OrderedDict()

    @functools.wraps(step)
    def run(cfg, state, block):
        dev = pytree.tree_leaves(state)[0].device
        if dev.type != "cuda":
            return step(cfg, state, block)
        block = as_block(block, dev)
        key = graph_key(step, cfg, state, block)
        if key not in graphs:
            graphs[key] = StepGraph(step, cfg, state, block)
            run.captures += 1
        result = graphs[key](state, block)
        graphs.move_to_end(key)
        while len(graphs) > MAX_KEYS:
            graphs.popitem(last=False)
        return result

    run.graphs = graphs
    run.captures = 0
    return run
