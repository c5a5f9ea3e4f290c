from rx_tools_tpu_torch.models.fmchain import (  # noqa: F401
    FmConfig, FmState, fm_chain_step, init_state, plan_capture)
from rx_tools_tpu_torch.models.power_plan import (  # noqa: F401
    TuningState, plan_sweep, describe_plan)
from rx_tools_tpu_torch.models.powerscan import (  # noqa: F401
    PowerConfig, SweepAccum, new_sweep_accum, power_hop_step, sweep_step,
    int_sweep_powers, csv_row_values)

__all__ = ["FmConfig", "FmState", "fm_chain_step", "init_state",
           "plan_capture", "TuningState", "plan_sweep", "describe_plan",
           "PowerConfig", "SweepAccum", "new_sweep_accum", "power_hop_step",
           "sweep_step", "int_sweep_powers", "csv_row_values"]
