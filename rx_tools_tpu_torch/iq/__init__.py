from rx_tools_tpu_torch.iq import formats, sources  # noqa: F401
