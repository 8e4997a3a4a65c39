"""Multi-device execution, the port of ``ncnet_tpu/parallel``: the device
mesh, the process group of data-parallel training, and the hB-sharded
volume forward (ROADMAP D7)."""

from ncnet_tpu_torch.parallel.distributed import (
    host_shard,
    initialize_distributed,
    shutdown_distributed,
)
from ncnet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    make_mesh,
)
from ncnet_tpu_torch.parallel.spatial import (
    spatial_correlation,
    spatial_filter,
    spatial_forward,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "host_shard",
    "initialize_distributed",
    "make_mesh",
    "shutdown_distributed",
    "spatial_correlation",
    "spatial_filter",
    "spatial_forward",
]
