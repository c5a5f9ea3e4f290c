"""Several devices and several processes: meshes, time / hop / channel
sharding and the gloo process group (counterpart of
:mod:`rx_tools_tpu.parallel`)."""

from rx_tools_tpu_torch.parallel.mesh import make_mesh, local_mesh
from rx_tools_tpu_torch.parallel.timeshard import (time_sharded_fm,
                                                   shard_recording)
from rx_tools_tpu_torch.parallel.hopshard import (hop_sharded_sweep,
                                                  shard_hop_blocks)
from rx_tools_tpu_torch.parallel.chanshard import channel_sharded_pfb_step
from rx_tools_tpu_torch.parallel import multihost

__all__ = [
    "make_mesh", "local_mesh",
    "time_sharded_fm", "shard_recording",
    "hop_sharded_sweep", "shard_hop_blocks",
    "channel_sharded_pfb_step",
    "multihost",
]
