"""Example pipelines on the port (``python -m rx_tools_tpu_torch.examples.<name>``)."""
