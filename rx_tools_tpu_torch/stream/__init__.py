from rx_tools_tpu_torch.stream.pipeline import RunnerStats  # noqa: F401
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner  # noqa: F401
from rx_tools_tpu_torch.stream.scan import (  # noqa: F401
    scan_fm_blocks, stack_blocks)

__all__ = ["RunnerStats", "ChunkedFmRunner", "scan_fm_blocks",
           "stack_blocks"]
