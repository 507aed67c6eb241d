"""Data parallelism over torch.distributed (port of livae_tpu/parallel/mesh.py,
its data-parallel half).

The JAX package shards the batch of one jitted step over a 1-D "data" mesh
and lets GSPMD insert the gradient all-reduce. Here each device is a process,
a rank: `spawn` starts N ranks with torch.multiprocessing, which meet through a
file store in a directory of the run (no network port), and every rank runs
the same training with a `DataMesh`. The fused steps of `train.engine` take it
as `mesh=`:

* every rank draws the GLOBAL batch's augmentation and reparameterisation
  noise from the same generator and keeps its rows (`shard_batch`), so the
  draws are those of one device;
* DistributedDataParallel averages the gradients. Every loss term is a batch
  mean, so the average over equal shards is the global mean; the clip then
  runs on the averaged gradients, identical on every rank;
* the rotation-diversity term is the std of theta over the whole batch, so
  theta is gathered with autograd before it (`gather_rows`);
* the metrics are all-reduced means, and the eval gathers its batch's outputs
  before it computes them.

A step over N ranks is therefore the step of one device, up to the order of
float32 sums. On the card rank r owns cuda:r and the backend is NCCL; with
`--cpu` the ranks are gloo processes. Tensor parallelism
(`--model-parallel M > 1`) is not ported: ROADMAP item 21.
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

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "all_reduce_mean",
    "gather_rows",
    "init_mesh",
    "local_device_count",
    "resolve_num_devices",
    "setup_mesh_from_flags",
    "shard_batch",
    "spawn",
]

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """The data axis of a run: this process is rank `rank` of `size` in the
    default process group."""

    rank: int
    size: int


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


def setup_mesh_from_flags(num_devices, model_parallel: int, batch_size: int,
                          device_type: str) -> int:
    """The trainers' check of --num-devices / --model-parallel: the number of
    data-parallel ranks (1: no mesh). Exits, as the JAX trainers do, on
    tensor parallelism, on more ranks than local devices, and on a batch the
    ranks cannot share equally."""
    if int(model_parallel) > 1:
        raise SystemExit(
            f"--model-parallel {model_parallel}: tensor parallelism is not ported; "
            "it is ROADMAP queue 1, item 21 (data parallelism is --num-devices)"
        )
    n = resolve_num_devices(num_devices, device_type)
    if n == 1:
        return 1
    available = local_device_count(device_type)
    if n > available:
        raise SystemExit(f"Requested {n} devices but only {available} available")
    if batch_size % n:
        raise SystemExit(
            f"--batch-size {batch_size} must be divisible by the data-parallel ways ({n})"
        )
    print(f"Data-parallel mesh: {n} {device_type} ranks")
    return n


def shard_batch(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """This rank's rows of a global batch along its leading axis (all of it
    without a mesh)."""
    if mesh is None:
        return x
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} cannot be shared by {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def gather_rows(x: torch.Tensor, mesh: DataMesh | None,
                differentiable: bool = False) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order (the global batch).
    `differentiable` gathers through autograd: the gradient of each rank's
    copy flows back to the rank that owns the rows."""
    if mesh is None:
        return x
    if differentiable:
        from torch.distributed.nn.functional import all_gather

        return torch.cat(all_gather(x), 0)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, 0)


def all_reduce_mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The mean of x over the ranks (x itself without a mesh)."""
    if mesh is None:
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out / mesh.size


def init_mesh(rank: int, size: int, backend: str, store_dir: str | Path) -> DataMesh:
    """Join the default process group as `rank` of `size`, meeting through a
    file store in `store_dir`, and return the mesh of it."""
    dist.init_process_group(backend, init_method=f"file://{Path(store_dir) / 'store'}",
                            rank=rank, world_size=size)
    return DataMesh(rank, size)


def _rank_main(rank: int, fn: Callable, size: int, store_dir: str, device_type: str,
               backend: str, threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if rank != 0:  # the run speaks through rank 0
        sys.stdout = open(os.devnull, "w")  # noqa: SIM115
    mesh = init_mesh(rank, size, backend, store_dir)
    try:
        result = fn(mesh, device, *args)
        if rank == 0:
            torch.save(result, Path(store_dir) / "result.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device_type: str, backend: str | None = None,
          root: str | Path = ".") -> Any:
    """Run fn(mesh, device, *args) on n ranks, one process each, and return
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
                  max(1, torch.get_num_threads() // n), args),
        )
        return torch.load(Path(store_dir) / "result.pt", weights_only=False)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
