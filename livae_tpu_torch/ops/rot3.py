"""Fused 3-shear rotation y = Sx(d_row) . Sy(d_col) . Sx(d_row) . x.

Port of livae_tpu/ops/pallas/rot3.py. Each S is a mod-P lerp shift
out[i] = (1-f) in[(i+k) mod P] + f in[(i+k+1) mod P], k = floor(d), f = d - k,
with d constant along the shifted axis (Sx: along W, one d_row per row; Sy:
along H, one d_col per column). Intermediates stay float32; the result is cast
once to the input dtype.

* `rot3_reference` is the plain PyTorch version: direct index gathers, and its
  gradients come from autograd.
* `Rot3Function` launches the hand-written CUDA kernels (ops/csrc/rot3.cu):
  one forward launch, one fused backward launch giving dx, d d_row and d d_col
  (or only the deltas, where x needs no gradient). Each launches one
  thread-block cluster per sample, with the f32 canvas in the cluster's shared
  memory; `launch_plan` sizes the cluster.
* `rot3` dispatches on the device: CPU tensors take the plain version, CUDA
  tensors the kernels; there is no fallback from one to the other.

Each launch adds one to the counter "rot3_fwd" or "rot3_bwd" of
`livae_tpu_torch.tracing`, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from .. import tracing
from . import _build
from .shear import fold_lanes, lerp_shift

__all__ = [
    "rot3", "rot3_reference", "Rot3Function", "MAX_P", "LaunchPlan", "launch_plan",
    "active_clusters",
]

# The kernels' limit (ops/csrc/rot3.cu, kMaxP): about the largest canvas whose
# backward fits a cluster of 8 blocks. Larger canvases take the per-shear path.
MAX_P = 432
WARPS = 8  # per block (kWarps)
SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on sm_90
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
# The cluster each kernel starts from, measured on the H100 by chip_smoke.py.
PREFERRED_CLUSTER = {"fwd": 4, "bwd": 8}


@dataclass(frozen=True)
class LaunchPlan:
    """One cluster of `cluster` blocks per sample. Block r owns rows
    [r * rows, min(P, (r + 1) * rows)) of every f32 intermediate, in `smem`
    bytes of dynamic shared memory."""

    P: int
    cluster: int
    rows: int
    smem: int

    @property
    def bands(self) -> list[range]:
        return [range(r * self.rows, min(self.P, (r + 1) * self.rows))
                for r in range(self.cluster)]


def _smem(P: int, rows: int, direction: str) -> int:
    """Bytes per block (the layout in ops/csrc/rot3.cu): P row pointers, the
    four shift tables, the band(s) and the per-warp row buffers; the backward
    adds the second band (u), a second row buffer per warp, ddc's partial
    and stage 3's ddr."""
    if direction == "fwd":
        return 8 * P + 4 * (4 * P + rows * P + WARPS * P)
    return 8 * P + 4 * (5 * P + rows + 2 * rows * P + 2 * WARPS * P)


def launch_plan(P: int, direction: str, cluster: int | None = None) -> LaunchPlan:
    """The launch of the rot3 kernel `direction` ("fwd" or "bwd") at canvas P.

    Starts from `cluster` (default PREFERRED_CLUSTER[direction]); halves it
    while a block would own no row, and doubles it while a block's shared
    memory would not fit. Raises ValueError for a canvas the kernels cannot take.
    """
    if direction not in PREFERRED_CLUSTER:
        raise ValueError(f"rot3 launch direction must be fwd or bwd, got {direction!r}")
    if not 2 <= P <= MAX_P:
        raise ValueError(f"rot3 kernel canvas must be 2..{MAX_P}, got {P}")
    n = PREFERRED_CLUSTER[direction] if cluster is None else cluster
    if n not in CLUSTER_SIZES:
        raise ValueError(f"rot3 cluster size must be one of {CLUSTER_SIZES}, got {n}")
    while n > 1 and (n - 1) * math.ceil(P / n) >= P:
        n //= 2
    while _smem(P, math.ceil(P / n), direction) > SMEM_PER_BLOCK and n < CLUSTER_SIZES[-1]:
        n *= 2
    rows = math.ceil(P / n)
    smem = _smem(P, rows, direction)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"rot3 {direction} at canvas {P} needs {smem} bytes of shared memory "
                         f"per block")
    return LaunchPlan(P, n, rows, smem)


def rot3_reference(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch rot3: x [B, P, P], d_row/d_col [B, P] -> like x."""
    v = x.float()
    v = lerp_shift(v, d_row.float(), 2)
    v = lerp_shift(v, d_col.float(), 1)
    v = lerp_shift(v, d_row.float(), 2)
    return v.to(x.dtype)


_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = _build.load("rot3")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        n = ctypes.c_long
        lib.livae_rot3_fwd.argtypes = [p, p, p, p, i, i, i, i, n, i, p]
        lib.livae_rot3_fwd.restype = i
        lib.livae_rot3_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, n, i, p]
        lib.livae_rot3_bwd.restype = i
        lib.livae_rot3_active_clusters.argtypes = [i, i, i, n, ctypes.POINTER(i)]
        lib.livae_rot3_active_clusters.restype = i
        _SIGNED = True
    return lib


def _check(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> tuple[int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"rot3 kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rot3 kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"rot3 needs a square canvas [B, P, P], got {tuple(x.shape)}")
    B, P = x.shape[0], x.shape[1]
    for name, d in (("d_row", d_row), ("d_col", d_col)):
        if d.shape != (B, P) or d.device != x.device:
            raise ValueError(f"{name} must be [{B}, {P}] on {x.device}, got "
                             f"{tuple(d.shape)} on {d.device}")
    return B, P


def _launch_fwd(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor,
                cluster: int | None = None) -> torch.Tensor:
    B, P = _check(x, d_row, d_col)
    plan = launch_plan(P, "fwd", cluster)
    lib = _lib()
    x = x.contiguous()
    d_row = d_row.float().contiguous()
    d_col = d_col.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.livae_rot3_fwd(
            x.data_ptr(), d_row.data_ptr(), d_col.data_ptr(), out.data_ptr(), B, P,
            plan.cluster, plan.rows, plan.smem, int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"rot3 forward kernel launch failed: CUDA error {err} ({plan})")
    tracing.count("rot3_fwd")
    return out


def _launch_bwd(x, d_row, d_col, g, with_dx: bool = True, cluster: int | None = None):
    """(dx or None, d d_row, d d_col); with_dx=False launches the dx-free variant."""
    B, P = _check(x, d_row, d_col)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("rot3 backward: the cotangent must match x in shape, dtype and device")
    plan = launch_plan(P, "bwd", cluster)
    lib = _lib()
    x = x.contiguous()
    g = g.contiguous()
    d_row = d_row.float().contiguous()
    d_col = d_col.float().contiguous()
    dx = torch.empty_like(x) if with_dx else None
    ddr = torch.empty((B, P), dtype=torch.float32, device=x.device)
    ddc = torch.empty((B, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.livae_rot3_bwd(
            x.data_ptr(), d_row.data_ptr(), d_col.data_ptr(), g.data_ptr(),
            dx.data_ptr() if with_dx else None, ddr.data_ptr(), ddc.data_ptr(),
            B, P, plan.cluster, plan.rows, plan.smem, int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"rot3 backward kernel launch failed: CUDA error {err} ({plan})")
    tracing.count("rot3_bwd")
    return dx, ddr, ddc


def active_clusters(plan: LaunchPlan, direction: str) -> int:
    """How many clusters of the bf16 kernel fit on the current card at once."""
    out = ctypes.c_int(0)
    err = _lib().livae_rot3_active_clusters(int(direction == "bwd"), plan.P, plan.cluster, plan.smem,
                                            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"rot3 occupancy query failed: CUDA error {err} ({plan})")
    return out.value


class Rot3Function(torch.autograd.Function):
    """rot3 through the CUDA kernels; the backward is the fused VJP kernel.

    Under `torch.func.vmap` (the stacked trials) the rule folds the lanes into
    the batch: K lanes of [B, P, P] make one launch on [K * B, P, P], and the
    backward, from plain autograd outside the vmap, one more. `torch.func.grad`
    cannot drive the backward: it hands it a functorch-wrapped cotangent, which
    has no data pointer for the kernel.
    """

    @staticmethod
    def forward(x, d_row, d_col):
        return _launch_fwd(x, d_row, d_col)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, d_row, d_col = ctx.saved_tensors
        # where x needs no gradient (the STN's rotation of the data patch), the
        # dx-free variant skips dx's lerp and store; the deltas keep their bits
        dx, ddr, ddc = _launch_bwd(x, d_row, d_col, g, with_dx=ctx.needs_input_grad[0])
        return dx, ddr.to(d_row.dtype), ddc.to(d_col.dtype)

    @staticmethod
    def vmap(info, in_dims, x, d_row, d_col):
        x, d_row, d_col = fold_lanes(info.batch_size, in_dims, x, d_row, d_col)
        return Rot3Function.apply(x, d_row, d_col).unflatten(0, (info.batch_size, -1)), 0


def rot3(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> torch.Tensor:
    """Fused 3-shear rotation of x [B, P, P] by per-row/per-column shifts [B, P].

    CPU tensors take `rot3_reference`; CUDA tensors launch the kernels or raise.
    """
    if x.device.type == "cpu":
        return rot3_reference(x, d_row, d_col)
    if x.device.type == "cuda":
        return Rot3Function.apply(x, d_row, d_col)
    raise ValueError(f"rot3 runs on CPU or CUDA tensors, got {x.device}")
