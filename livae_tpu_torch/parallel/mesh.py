"""Data and tensor parallelism over torch.distributed (port of
livae_tpu/parallel/mesh.py).

The JAX package shards the batch of one jitted step over a "data" mesh axis
and lets GSPMD insert the gradient all-reduce; with `--model-parallel M` the
mesh is 2-D ("data", "model") and the large dense kernels are placed
Megatron-style on "model". Here each device is a process, a rank: `spawn`
starts N ranks with torch.multiprocessing, which meet through a file store in
a directory of the run (no network port), and every rank runs the same
training with a `DataMesh`. Rank r has data index r // M and model index
r % M (the model axis innermost, as `make_mesh2d` lays it out); the mesh holds
this rank's data group (the ranks of its model index) and model group (the
ranks of its data index). The fused steps of `train.engine` take it as
`mesh=`:

* every rank draws the GLOBAL batch's augmentation and reparameterisation
  noise from the same generator and keeps its data index's rows
  (`shard_batch`), so the draws are those of one device; the ranks of one
  model group hold the same rows;
* DistributedDataParallel averages the gradients over the data group. Every
  loss term is a batch mean, so the average over equal shards is the global
  mean; the clip then runs on the averaged gradients;
* the rotation-diversity term is the std of theta over the whole batch, so
  theta is gathered over the data group with autograd before it
  (`gather_rows`);
* the metrics are means over the data group, and the eval gathers its
  batch's outputs over it before it computes them.

Tensor parallelism: `dense_param_specs` picks the dense layers to split (the
JAX rule, through the [in, out] -> [out, in] layout change) and
`place_with_specs` swaps them for the row- and column-parallel layers of
parallel/tensor.py, whose collectives run over the model group. The models
need no change.

A step over N ranks is therefore the step of one device, up to the order of
float32 sums. On the card rank r owns cuda:r and the backend is NCCL; with
`--cpu` the ranks are gloo processes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from .tensor import ColumnParallelLinear, RowParallelLinear, tp_boundary

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "all_reduce_mean",
    "dense_param_specs",
    "gather_rows",
    "init_mesh",
    "local_device_count",
    "make_mesh2d",
    "place_with_specs",
    "resolve_num_devices",
    "setup_mesh_from_flags",
    "shard_batch",
    "spawn",
    "tp_boundary",
]

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """This rank's place in the ("data", "model") mesh of a run: data index
    `rank` of `size` data ways, model index `model_rank` of `model_size`
    model ways, and the process groups of its two axes (None: the default
    group, which a mesh of one model way uses for its data axis)."""

    rank: int
    size: int
    model_rank: int = 0
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def world_rank(self) -> int:
        """The rank in the default group: data index x model ways + model index."""
        return self.rank * self.model_size + self.model_rank


def local_device_count(device_type: str) -> int:
    """The devices one host offers ranks: its cards, or its cores with --cpu."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def resolve_num_devices(spec: str | int | None, device_type: str = "cuda") -> int:
    """Parse a --num-devices value: an int, "auto" (every local card; one on
    the CPU) or None (1)."""
    if spec is None:
        return 1
    if isinstance(spec, str):
        if spec.lower() == "auto":
            return max(1, torch.cuda.device_count()) if device_type == "cuda" else 1
        spec = int(spec)
    if spec < 1:
        raise ValueError(f"--num-devices must be >= 1 or 'auto', got {spec}")
    return spec


def dense_param_specs(model: torch.nn.Module, n_model: int,
                      min_dim: int = 1024) -> dict[str, int]:
    """Megatron-style placement of the large dense layers: {parameter name:
    the dim it is split along over the model axis}.

    The JAX rule on torch's [out, in] weights: for every nn.Linear, the
    largest axis that is at least `min_dim` and divisible by n_model is split
    (the input features first on a tie, as JAX takes its [in, out] kernel's
    axis 0). Split input features (dim 1) make a row-parallel layer, whose
    bias stays whole; split output features (dim 0) a column-parallel layer,
    whose bias is split with them. Convolutions and small dense layers stay
    replicated."""
    specs: dict[str, int] = {}
    for name, m in model.named_modules():
        if not isinstance(m, torch.nn.Linear):
            continue
        out_f, in_f = m.weight.shape
        candidates = [(n, d) for n, d in ((in_f, 1), (out_f, 0))
                      if n >= min_dim and n % n_model == 0]
        if not candidates:
            continue
        dim = max(candidates, key=lambda c: c[0])[1]
        specs[f"{name}.weight"] = dim
        if dim == 0 and m.bias is not None:
            specs[f"{name}.bias"] = 0
    return specs


def place_with_specs(model: torch.nn.Module, mesh: DataMesh,
                     specs: dict[str, int]) -> torch.nn.Module:
    """Swap each nn.Linear that `specs` splits, in place, for the row- or
    column-parallel layer holding this rank's slice of its weights (also
    inside an nn.Sequential). Build the optimizer after this: it must hold
    the new layers' parameters. Returns the model."""
    for key, dim in specs.items():
        if key.endswith(".weight"):
            parent_name, _, child = key.removesuffix(".weight").rpartition(".")
            parent = model.get_submodule(parent_name)
            layer = RowParallelLinear if dim == 1 else ColumnParallelLinear
            setattr(parent, child, layer(getattr(parent, child), mesh))
    return model


def setup_mesh_from_flags(num_devices, model_parallel: int, batch_size: int,
                          device_type: str, model: torch.nn.Module | None = None
                          ) -> tuple[int, int]:
    """The trainers' check of --num-devices / --model-parallel: (data ways,
    model ways), (1, 1) without a mesh. Exits, as the JAX trainers do, when
    the model ways do not divide the devices or the batch does not divide
    among the data ways, and on more ranks than local devices. With
    --model-parallel M > 1 it prints the JAX trainers' line, counting the
    parameters `dense_param_specs` splits in `model`."""
    n = resolve_num_devices(num_devices, device_type)
    mp = max(1, int(model_parallel))
    if n % mp:
        raise SystemExit(f"--num-devices {n} must be divisible by --model-parallel {mp}")
    n_data = n // mp
    if n == 1:
        return 1, 1
    available = local_device_count(device_type)
    if n > available:
        raise SystemExit(f"Requested {n} devices but only {available} available")
    if batch_size % n_data:
        raise SystemExit(
            f"--batch-size {batch_size} must be divisible by the data-parallel ways "
            f"({n_data} = --num-devices/--model-parallel)"
        )
    if mp == 1:
        print(f"Data-parallel mesh: {n} {device_type} ranks")
        return n, 1
    n_sharded = 0 if model is None else len(dense_param_specs(model, mp))
    print(f"2-D mesh: {n_data} data x {mp} model {{'data': {n_data}, 'model': {mp}}}; "
          f"{n_sharded} model-sharded dense params")
    if n_sharded == 0:
        print("  note: no dense kernel is large enough to shard at this patch size "
              "— running as pure data parallelism")
    return n_data, mp


def shard_batch(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """This rank's rows of a global batch along its leading axis, by data
    index (all of it without a mesh)."""
    if mesh is None:
        return x
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} cannot be shared by {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def gather_rows(x: torch.Tensor, mesh: DataMesh | None,
                differentiable: bool = False) -> torch.Tensor:
    """Every data index's rows of x, concatenated in data order (the global
    batch), over the data group. `differentiable` gathers through autograd:
    the gradient of each rank's copy flows back to the rank that owns the
    rows."""
    if mesh is None or mesh.size == 1:
        return x
    if differentiable:
        return _GatherRows.apply(x, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, 0)


class _GatherRows(torch.autograd.Function):
    """gather_rows with a backward: the sum over the data group of every
    rank's gradient of the global batch, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        return shard_batch(g, ctx.mesh), None


def all_reduce_mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The mean of x over the data group (x itself without a mesh or with one
    data way)."""
    if mesh is None or mesh.size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out / mesh.size


def init_mesh(rank: int, size: int, backend: str, store_dir: str | Path,
              model_parallel: int = 1) -> DataMesh:
    """Join the default process group as `rank` of `size`, meeting through a
    file store in `store_dir`, and return this rank's mesh of
    size / model_parallel data ways x model_parallel model ways."""
    dist.init_process_group(backend, init_method=f"file://{Path(store_dir) / 'store'}",
                            rank=rank, world_size=size)
    return make_mesh2d(size // model_parallel, model_parallel)


def make_mesh2d(n_data: int, n_model: int) -> DataMesh:
    """This rank's ("data", "model") mesh of n_data x n_model ranks, called
    inside a rank of the default group. The model axis is innermost: rank r
    has data index r // n_model and model index r % n_model. Every rank
    creates every subgroup, in the same order, as `dist.new_group` needs."""
    world, r = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, "
                         f"the group has {world}")
    if n_model == 1:
        return DataMesh(r, world)
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(r, n_model)
    return DataMesh(d, n_data, m, n_model, data_groups[m], model_groups[d])


def _rank_main(rank: int, fn: Callable, size: int, store_dir: str, device_type: str,
               backend: str, threads: int, model_parallel: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if rank != 0:  # the run speaks through rank 0
        sys.stdout = open(os.devnull, "w")  # noqa: SIM115
    mesh = init_mesh(rank, size, backend, store_dir, model_parallel)
    try:
        result = fn(mesh, device, *args)
        if rank == 0:
            torch.save(result, Path(store_dir) / "result.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device_type: str, backend: str | None = None,
          root: str | Path = ".", model_parallel: int = 1) -> Any:
    """Run fn(mesh, device, *args) on n ranks, one process each, as a mesh of
    n / model_parallel data ways x model_parallel model ways, and return
    rank 0's result (it must pickle).

    The ranks meet through a file store in a fresh directory under `root`,
    removed afterwards. On the card rank r runs on cuda:(r mod cards) and the
    backend defaults to NCCL; on the CPU to gloo. The ranks share this
    process's torch threads (at least one each): more would have them spin
    against each other on the host's cores. A failed rank raises here.
    """
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    Path(root).mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix=".ranks-", dir=root)
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=n, join=True,
            args=(fn, n, store_dir, device_type, backend,
                  max(1, torch.get_num_threads() // n), model_parallel, args),
        )
        return torch.load(Path(store_dir) / "result.pt", weights_only=False)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
