from rx_tools_tpu_torch.stream.pipeline import (  # noqa: F401
    StreamRunner, RunnerStats)
from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner  # noqa: F401
from rx_tools_tpu_torch.stream.scan import (  # noqa: F401
    scan_fm_blocks, stack_blocks)
from rx_tools_tpu_torch.stream.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint)

__all__ = ["StreamRunner", "RunnerStats", "ChunkedFmRunner",
           "scan_fm_blocks", "stack_blocks", "save_checkpoint",
           "load_checkpoint"]
