"""Megatron tensor parallelism: the split dense layers and their collectives
(port of the model-axis half of livae_tpu/parallel/mesh.py).

The JAX package places the large dense kernels on a "model" mesh axis and
lets GSPMD insert the collectives, with `tp_boundary` marking where the
model axis is gathered. Here the split is written out: `place_with_specs`
(parallel/mesh.py) swaps an nn.Linear for

* `RowParallelLinear`, its weight split along the input features: scatter
  the input (each rank keeps its slice), a local matmul (model index 0's
  with the whole bias), then an all-reduce of the partial sums;
* `ColumnParallelLinear`, its weight and bias split along the output
  features: the input copied to every rank, a local matmul with the local
  bias, then the outputs gathered.

The four collectives are autograd Functions over the mesh's model group:
scatter (backward: gather), reduce (backward: identity), copy (backward:
all-reduce) and gather (backward: scatter). Every gather is an all-reduce of
a zero-filled full buffer holding this rank's slice: adding zeros is exact,
and gloo, which the ranks on one card must use, cannot all-gather CUDA
tensors. So the same code runs on gloo and NCCL. Every rank of a model group
must run every forward of the model, or the collectives wait for ever.

The layers keep the attribute names `weight` and `bias`, so the state-dict
keys stay the reference's; a split parameter carries `model_parallel_dim`,
the dim it is split along. `full_state_dict` and `full_optimizer_state`
gather the one-device state (every rank must call them), and their `load_`
inverses slice it again.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "full_optimizer_state",
    "full_state_dict",
    "is_model_sharded",
    "load_full_optimizer_state",
    "load_full_state_dict",
    "tp_boundary",
    "unplace",
]


def _slice(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model index's slice of x along `dim`."""
    k = x.shape[dim] // mesh.model_size
    return x.narrow(dim, mesh.model_rank * k, k)


def _gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every model index's slice of x along `dim`, concatenated: an all-reduce
    of a zero-filled full buffer with this rank's slice written in."""
    shape = list(x.shape)
    shape[dim] *= mesh.model_size
    full = x.new_zeros(shape)
    _slice(full, dim, mesh).copy_(x)
    dist.all_reduce(full, group=mesh.model_group)
    return full


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=mesh.model_group)
    return out


class _ScatterToModel(torch.autograd.Function):
    """Forward: this rank's slice of the last axis; backward: the gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice(x, -1, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, -1, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the sum over the model group; backward: the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity; backward: the sum over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the gather of the last axis; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, -1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, -1, ctx.mesh).contiguous(), None


def tp_boundary(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """End a column-parallel region: gather the last (feature) axis over the
    model group, with autograd. A no-op without a model axis, as in JAX."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _GatherFromModel.apply(x, mesh)


def _split_parameter(t: torch.Tensor, dim: int | None, mesh, requires_grad: bool):
    p = nn.Parameter((t if dim is None else _slice(t, dim, mesh)).detach().clone(),
                     requires_grad=requires_grad)
    if dim is not None:
        p.model_parallel_dim = dim
    return p


class RowParallelLinear(nn.Module):
    """An nn.Linear with its weight split along the input features over the
    mesh's model group: each rank multiplies its slice of the input by its
    slice of the weight, and the partial outputs, one of them with the whole
    bias, are summed. Built from the full layer, whose weights it slices."""

    def __init__(self, linear: nn.Linear, mesh):
        super().__init__()
        self.mesh = mesh
        self.in_features, self.out_features = linear.in_features, linear.out_features
        req = linear.weight.requires_grad
        self.weight = _split_parameter(linear.weight, 1, mesh, req)
        self.bias = _split_parameter(linear.bias, None, mesh, req)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ScatterToModel.apply(x, self.mesh)
        # The bias rides on model index 0's partial product, where nn.Linear's
        # addmm puts it (added after the sum it rounds otherwise, and Adam's
        # first steps amplify that); the other indices add bias - bias, a zero
        # through which the bias still gets its whole gradient on every rank.
        bias = self.bias if self.mesh.model_rank == 0 else self.bias - self.bias.detach()
        return _ReduceFromModel.apply(F.linear(x, self.weight, bias), self.mesh)


class ColumnParallelLinear(nn.Module):
    """An nn.Linear with its weight and bias split along the output features
    over the mesh's model group: each rank computes its slice of the output,
    and the slices are gathered (`tp_boundary`). Built from the full layer,
    whose weights it slices."""

    def __init__(self, linear: nn.Linear, mesh):
        super().__init__()
        self.mesh = mesh
        self.in_features, self.out_features = linear.in_features, linear.out_features
        req = linear.weight.requires_grad
        self.weight = _split_parameter(linear.weight, 0, mesh, req)
        self.bias = _split_parameter(linear.bias, 0, mesh, req)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.mesh)
        return tp_boundary(F.linear(x, self.weight, self.bias), self.mesh)


def is_model_sharded(p: torch.Tensor) -> bool:
    """Whether a parameter holds a slice of a split layer."""
    return getattr(p, "model_parallel_dim", None) is not None


def full_state_dict(model: nn.Module, mesh=None) -> dict[str, torch.Tensor]:
    """The one-device state dict of a placed model: every split parameter
    gathered over the model group (every rank of it must call this). Without
    a model axis, `model.state_dict()`."""
    state = model.state_dict()
    if mesh is None or mesh.model_size == 1:
        return state
    for name, p in model.named_parameters():
        if is_model_sharded(p):
            state[name] = _gather(p.detach(), p.model_parallel_dim, mesh)
    return state


def load_full_state_dict(model: nn.Module, state: dict, mesh=None) -> None:
    """Load a one-device state dict into a placed model, each split
    parameter sliced to this rank's part (strict)."""
    if mesh is not None and mesh.model_size > 1:
        state = dict(state)
        for name, p in model.named_parameters():
            if is_model_sharded(p):
                state[name] = _slice(state[name], p.model_parallel_dim, mesh)
    model.load_state_dict(state, strict=True)


def _optimizer_params(optimizer) -> list[torch.Tensor]:
    """The optimizer's parameters in its state dict's order."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def _map_moments(state: dict, optimizer, fn) -> dict:
    """The optimizer state dict with fn(tensor, dim) applied to every moment
    of each split parameter (its 0-d step count left as it is)."""
    state = {**state, "state": dict(state["state"])}
    for i, p in enumerate(_optimizer_params(optimizer)):
        if i in state["state"] and is_model_sharded(p):
            state["state"][i] = {
                k: fn(v, p.model_parallel_dim) if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in state["state"][i].items()}
    return state


def full_optimizer_state(optimizer, mesh=None) -> dict[str, Any]:
    """The optimizer's state dict as one device holds it: the moments of
    every split parameter gathered over the model group (every rank of it must
    call this)."""
    state = optimizer.state_dict()
    if mesh is None or mesh.model_size == 1:
        return state
    return _map_moments(state, optimizer, lambda v, dim: _gather(v, dim, mesh))


def load_full_optimizer_state(optimizer, state: dict, mesh=None) -> None:
    """Load a one-device optimizer state dict, each split parameter's moments
    sliced to this rank's part."""
    if mesh is not None and mesh.model_size > 1:
        state = _map_moments(state, optimizer, lambda v, dim: _slice(v, dim, mesh).clone())
    optimizer.load_state_dict(state)


def unplace(model: nn.Module) -> nn.Module:
    """Swap every split layer of a placed model back, in place, for an
    nn.Linear holding the full weights gathered over the model group (every
    rank of it must call this): the one-device model, which pickles.
    Returns the model."""
    split = [(name, m) for name, m in model.named_modules()
             if isinstance(m, (RowParallelLinear, ColumnParallelLinear))]
    for name, layer in split:
        parent_name, _, child = name.rpartition(".")
        linear = nn.Linear(layer.in_features, layer.out_features, device="meta")
        for attr in ("weight", "bias"):
            p = getattr(layer, attr)
            full = p.detach().clone()
            if is_model_sharded(p):
                full = _gather(full, p.model_parallel_dim, layer.mesh)
            setattr(linear, attr, nn.Parameter(full, requires_grad=p.requires_grad))
        setattr(model.get_submodule(parent_name), child, linear)
    return model
