"""Data parallelism over torch.distributed (port of livae_tpu/parallel)."""

from .mesh import (
    DATA_AXIS,
    DataMesh,
    all_reduce_mean,
    gather_rows,
    init_mesh,
    resolve_num_devices,
    setup_mesh_from_flags,
    shard_batch,
    spawn,
)

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "all_reduce_mean",
    "gather_rows",
    "init_mesh",
    "resolve_num_devices",
    "setup_mesh_from_flags",
    "shard_batch",
    "spawn",
]
