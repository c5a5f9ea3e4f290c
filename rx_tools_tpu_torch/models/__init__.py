from rx_tools_tpu_torch.models.fmchain import (  # noqa: F401
    FmConfig, FmState, fm_chain_step, init_state, plan_capture)
from rx_tools_tpu_torch.models import power_plan  # noqa: F401
from rx_tools_tpu_torch.models.power_plan import (  # noqa: F401
    TuningState, plan_sweep, describe_plan)
from rx_tools_tpu_torch.models.powerscan import (  # noqa: F401
    PowerConfig, SweepAccum, new_sweep_accum, power_hop_step, sweep_step,
    int_sweep_powers, csv_row_values)

__all__ = ["FmConfig", "FmState", "fm_chain_step", "init_state",
           "plan_capture", "power_plan", "TuningState", "plan_sweep", "describe_plan",
           "PowerConfig", "SweepAccum", "new_sweep_accum", "power_hop_step",
           "sweep_step", "int_sweep_powers", "csv_row_values"]
from rx_tools_tpu_torch.models import channelizer, pfb, tmaj  # noqa: F401,E402
from rx_tools_tpu_torch.models.channelizer import (  # noqa: F401,E402
    ChannelizerConfig, ChannelizerState, ChannelizerStateTM,
    channelize_step, channelize_step_tmaj, channelize_scan_blocks_tmaj)
from rx_tools_tpu_torch.models.pfb import (  # noqa: F401,E402
    PfbConfig, PfbState, PfbStateTM, pfb_step, pfb_step_tmaj,
    pfb_scan_blocks_tmaj)

__all__ += ["channelizer", "pfb", "tmaj", "ChannelizerConfig",
            "ChannelizerState", "ChannelizerStateTM", "channelize_step",
            "channelize_step_tmaj", "channelize_scan_blocks_tmaj",
            "PfbConfig", "PfbState", "PfbStateTM", "pfb_step",
            "pfb_step_tmaj", "pfb_scan_blocks_tmaj"]
