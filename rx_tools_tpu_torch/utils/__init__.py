from rx_tools_tpu_torch.utils import units, logging, wav  # noqa: F401
