"""The port's entry point: one step of the flagship model.

Twin of the repository's ``__graft_entry__.entry()``: ``(fn, (state,
block))`` for the WBFM demodulation chain, ``fn(state, block)`` being
:func:`rx_tools_tpu_torch.models.fmchain.fm_chain_step` under the ``-M
wbfm`` preset planned for 100.3 MHz.  The state lives on the CUDA device
unless ``device="cpu"`` (or ``RX_PLATFORM=cpu``) asks for the CPU.
"""

from __future__ import annotations

import functools

import numpy as np

from rx_tools_tpu_torch.models import fmchain


def entry(device=None):
    cfg = fmchain.wbfm_preset()
    cfg, _, _ = fmchain.plan_capture(cfg, 100.3e6)
    n = fmchain.block_samples(cfg)
    state = fmchain.init_state(cfg, device)
    block = np.zeros(2 * n, np.int16)
    fn = functools.partial(fmchain.fm_chain_step, cfg)
    return fn, (state, block)
