from rx_tools_tpu_torch.models.fmchain import (  # noqa: F401
    FmConfig, FmState, fm_chain_step, init_state, plan_capture)

__all__ = ["FmConfig", "FmState", "fm_chain_step", "init_state",
           "plan_capture"]
