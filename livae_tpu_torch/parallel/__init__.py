"""Data and tensor parallelism over torch.distributed (port of livae_tpu/parallel)."""

from .mesh import (
    DATA_AXIS,
    DataMesh,
    all_reduce_mean,
    dense_param_specs,
    gather_rows,
    init_mesh,
    make_mesh2d,
    place_with_specs,
    resolve_num_devices,
    setup_mesh_from_flags,
    shard_batch,
    spawn,
)
from .tensor import (
    ColumnParallelLinear,
    RowParallelLinear,
    full_optimizer_state,
    full_state_dict,
    load_full_optimizer_state,
    load_full_state_dict,
    tp_boundary,
    unplace,
)

__all__ = [
    "DATA_AXIS",
    "ColumnParallelLinear",
    "DataMesh",
    "RowParallelLinear",
    "all_reduce_mean",
    "dense_param_specs",
    "full_optimizer_state",
    "full_state_dict",
    "gather_rows",
    "init_mesh",
    "load_full_optimizer_state",
    "load_full_state_dict",
    "make_mesh2d",
    "place_with_specs",
    "resolve_num_devices",
    "setup_mesh_from_flags",
    "shard_batch",
    "spawn",
    "tp_boundary",
    "unplace",
]
