"""One fractional shift along an axis (port of livae_tpu/ops/pallas/shear.py).

x is [B, H, W]. axis=2 shifts along W with one delta per row (delta [B, H]);
axis=1 shifts along H with one delta per column (delta [B, W]). With n the
length of the shifted axis, k = floor(d) and f = d - k:

    out[i] = (1-f) x[(i+k) mod n] + f x[(i+k+1) mod n]

in float32, cast once to x's dtype. Three such shifts make a rotation (the
per-shear path of ops.resample.rotate_image_fast).

* `fractional_shift_reference` is the plain PyTorch version; its gradients
  come from autograd. `fractional_shift_vjp_reference` is the JAX package's
  VJP formula (shear.py:124-137) in plain PyTorch.
* `FractionalShiftFunction` launches the hand-written CUDA kernels
  (ops/csrc/shear.cu): one forward launch, and one fused backward launch
  giving dx (by the VJP formula) and d delta, or only d delta where x needs
  no gradient. Each block stages one tile in shared memory; `launch_plan`
  sizes the tiles.
* `fractional_shift` dispatches on the device: CPU tensors take the plain
  version, CUDA tensors the kernels; there is no fallback from one to the
  other.

Each launch adds one to the counter "shear_fwd" or "shear_bwd" of
`livae_tpu_torch.tracing`, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import tracing
from . import _build

__all__ = [
    "fractional_shift",
    "fractional_shift_reference",
    "fractional_shift_vjp_reference",
    "FractionalShiftFunction",
    "lerp_shift",
    "ShearPlan",
    "launch_plan",
    "blocks_per_sm",
]

THREADS = 256  # per block (kThreads in ops/csrc/shear.cu)
SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on sm_90
# The tile sizes, measured on the H100 (PERF.md, section 6): axis 2 stages about
# ROW_TILE_BYTES of x's rows per block; axis 1 the widest strip of
# STRIP_COLUMNS whose strips (x's, and g's in the backward) stay within
# STRIP_BYTES, which keeps three blocks on an SM.
ROW_TILE_BYTES = 16 * 1024
STRIP_BYTES = 64 * 1024
STRIP_COLUMNS = (64, 32, 16, 8)


@dataclass(frozen=True)
class ShearPlan:
    """The launch of a kernel C instance on x [B, H, W]: one block per tile.

    variant "tiled": axis 2 stages `tile` consecutive rows of the flattened
    [B H, W] array per block, axis 1 a strip of `tile` columns by all H rows
    of one sample; x's tile (and g's in the backward) take `smem` bytes of
    shared memory. variant "direct": the tile does not fit one block, and the
    kernel gathers in device memory (tile and smem 0).
    """

    B: int
    H: int
    W: int
    axis: int
    direction: str
    variant: str
    tile: int
    smem: int

    def tiles(self) -> list:
        """What each block's tile covers, in block order: axis 2 a range of
        flat rows b * H + y; axis 1 (b, range of columns). The direct variant:
        one row (axis 2) or one column (axis 1, as (b, range(c, c + 1))) each."""
        B, H, W = self.B, self.H, self.W
        if self.axis == 2:
            R = self.tile or 1
            return [range(r, min(B * H, r + R)) for r in range(0, B * H, R)]
        w = self.tile or 1
        return [(b, range(c, min(W, c + w))) for b in range(B) for c in range(0, W, w)]


def _tile_bytes(axis: int, H: int, W: int, tile: int, elem: int) -> int:
    """One staged tile of one tensor (tile_bytes in ops/csrc/shear.cu): axis 2
    `tile` rows plus 16 bytes for the span's misalignment, axis 1 [H][tile];
    rounded up to 16 bytes."""
    n = (tile * W + 16 // elem) * elem if axis == 2 else H * tile * elem
    return -(-n // 16) * 16


def _tensors(direction: str) -> int:
    """Tensors a kernel stages: x, and g in the backward."""
    return 1 if direction == "fwd" else 2


def _smem(axis: int, direction: str, H: int, W: int, tile: int, elem: int) -> int:
    """Bytes per block: x's tile (and g's in the backward), and for the axis-1
    backward one f32 partial of d delta per thread."""
    tensors = _tensors(direction)
    extra = 4 * THREADS if (axis == 1 and direction == "bwd") else 0
    return tensors * _tile_bytes(axis, H, W, tile, elem) + extra


def launch_plan(B: int, H: int, W: int, axis: int, direction: str, dtype: torch.dtype,
                tile: int | None = None) -> ShearPlan:
    """The launch of kernel C `direction` ("fwd" or "bwd") along `axis` on x
    [B, H, W] of `dtype` (float32 or bfloat16).

    axis 2 stages about ROW_TILE_BYTES of rows per block, at least one row;
    axis 1 the widest strip of STRIP_COLUMNS whose strips of x (and g) take
    at most STRIP_BYTES, or the narrowest. A tile that does not fit one
    block's shared memory takes the direct variant. `tile` picks a tiled plan
    by hand (rows, or a power of two from 8 to THREADS columns); ValueError
    if it does not fit.
    """
    if axis not in (1, 2):
        raise ValueError(f"kernel C shifts along axis 1 or 2, got {axis}")
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"kernel C direction must be fwd or bwd, got {direction!r}")
    if min(B, H, W) < 1:
        raise ValueError(f"kernel C needs a non-empty [B, H, W], got {[B, H, W]}")
    elem = {torch.float32: 4, torch.bfloat16: 2}[dtype]
    if tile is not None:
        if axis == 2:
            ok = 1 <= tile <= B * H
        else:
            ok = 8 <= tile <= THREADS and not tile & (tile - 1)
        smem = _smem(axis, direction, H, W, tile, elem) if ok else 0
        if not ok or smem > SMEM_PER_BLOCK:
            raise ValueError(f"kernel C {direction} axis {axis} on {[B, H, W]} {dtype}: tile "
                             f"{tile} is not a tile the kernels take within {SMEM_PER_BLOCK} B")
        return ShearPlan(B, H, W, axis, direction, "tiled", tile, smem)
    if axis == 2:
        tile = min(B * H, max(1, ROW_TILE_BYTES // (W * elem)))
    else:
        fit = [w for w in STRIP_COLUMNS if _tensors(direction) * H * w * elem <= STRIP_BYTES]
        tile = fit[0] if fit else STRIP_COLUMNS[-1]
    smem = _smem(axis, direction, H, W, tile, elem)
    if smem > SMEM_PER_BLOCK:
        return ShearPlan(B, H, W, axis, direction, "direct", 0, 0)
    return ShearPlan(B, H, W, axis, direction, "tiled", tile, smem)


def lerp_shift(v: torch.Tensor, delta: torch.Tensor, dim: int) -> torch.Tensor:
    """out = (1-f) v[(i+k) mod n] + f v[(i+k+1) mod n] along `dim` of [B, H, W].

    delta: one shift per row ([B, H], dim=2) or per column ([B, W], dim=1),
    in v's dtype. No cast: the caller picks the arithmetic's type.
    """
    n = v.shape[dim]
    k = torch.floor(delta).detach()
    f = delta - k
    ar = torch.arange(n, device=v.device)
    if dim == 2:
        i0 = torch.remainder(ar[None, None, :] + k.long()[:, :, None], n)
        f = f[:, :, None]
    else:
        i0 = torch.remainder(ar[None, :, None] + k.long()[:, None, :], n)
        f = f[:, None, :]
    i1 = torch.remainder(i0 + 1, n)
    g0 = torch.gather(v, dim, i0)
    g1 = torch.gather(v, dim, i1)
    return (1.0 - f) * g0 + f * g1


def _check_shapes(x: torch.Tensor, delta: torch.Tensor, axis: int) -> tuple[int, int, int]:
    if axis not in (1, 2):
        raise ValueError(f"fractional_shift shifts along axis 1 or 2, got {axis}")
    if x.dim() != 3:
        raise ValueError(f"fractional_shift takes x [B, H, W], got {tuple(x.shape)}")
    B, H, W = x.shape
    want = (B, H if axis == 2 else W)
    if tuple(delta.shape) != want or delta.device != x.device:
        raise ValueError(f"delta must be {list(want)} on {x.device} for axis {axis}, got "
                         f"{tuple(delta.shape)} on {delta.device}")
    return B, H, W


def fractional_shift_reference(x: torch.Tensor, delta: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain PyTorch shift: f32 inside, one cast to x's dtype."""
    _check_shapes(x, delta, axis)
    return lerp_shift(x.float(), delta.float(), axis).to(x.dtype)


def fractional_shift_vjp_reference(x, delta, g, axis: int):
    """(dx, d delta) by the JAX package's VJP (livae_tpu/ops/pallas/shear.py:124-137).

    dx is the shift of g by -delta. d delta sums f32(g1 - g0) * f32(g) over
    the shifted axis, with g0 the shift of x by floor(delta) and g1 = g0
    rolled by -1; g0 and g1 are in x's dtype, so for bf16 the difference is
    rounded to bf16 before the product, as in JAX.
    """
    dx = fractional_shift_reference(g, -delta, axis)
    g0 = fractional_shift_reference(x, torch.floor(delta), axis)
    g1 = torch.roll(g0, -1, dims=axis)
    ddelta = ((g1 - g0).float() * g.float()).sum(dim=axis)
    return dx, ddelta.to(delta.dtype)


_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = _build.load("shear")
    if not _SIGNED:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.livae_shear_fwd.argtypes = [p, p, p, i, i, i, i, i, i, n, p]
        lib.livae_shear_fwd.restype = i
        lib.livae_shear_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, n, p]
        lib.livae_shear_bwd.restype = i
        lib.livae_shear_blocks_per_sm.argtypes = [i, i, i, n, ctypes.POINTER(i)]
        lib.livae_shear_blocks_per_sm.restype = i
        _SIGNED = True
    return lib


def _check(x: torch.Tensor, delta: torch.Tensor, axis: int) -> tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"shear kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"shear kernel takes float32 or bfloat16, got {x.dtype}")
    return _check_shapes(x, delta, axis)


def _launch_fwd(x: torch.Tensor, delta: torch.Tensor, axis: int,
                plan: ShearPlan | None = None) -> torch.Tensor:
    B, H, W = _check(x, delta, axis)
    plan = plan or launch_plan(B, H, W, axis, "fwd", x.dtype)
    lib = _lib()
    x = x.contiguous()
    delta = delta.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.livae_shear_fwd(x.data_ptr(), delta.data_ptr(), out.data_ptr(), B, H, W,
                                  axis, int(x.dtype == torch.bfloat16), plan.tile, plan.smem,
                                  stream)
    if err != 0:
        raise RuntimeError(f"shear forward kernel launch failed: CUDA error {err} ({plan})")
    tracing.count("shear_fwd")
    return out


def _launch_bwd(x: torch.Tensor, delta: torch.Tensor, g: torch.Tensor, axis: int,
                with_dx: bool = True, plan: ShearPlan | None = None):
    """(dx or None, d delta); with_dx=False launches the dx-free variant."""
    B, H, W = _check(x, delta, axis)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("shear backward: the cotangent must match x in shape, dtype and device")
    plan = plan or launch_plan(B, H, W, axis, "bwd", x.dtype)
    lib = _lib()
    x = x.contiguous()
    g = g.contiguous()
    delta = delta.float().contiguous()
    dx = torch.empty_like(x) if with_dx else None
    ddelta = torch.empty_like(delta)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.livae_shear_bwd(x.data_ptr(), delta.data_ptr(), g.data_ptr(),
                                  dx.data_ptr() if with_dx else None, ddelta.data_ptr(),
                                  B, H, W, axis, int(x.dtype == torch.bfloat16), plan.tile,
                                  plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"shear backward kernel launch failed: CUDA error {err} ({plan})")
    tracing.count("shear_bwd")
    return dx, ddelta


def blocks_per_sm(plan: ShearPlan, dtype: torch.dtype) -> int:
    """How many blocks of the tiled kernel of `plan` fit one SM of the current card."""
    out = ctypes.c_int(0)
    err = _lib().livae_shear_blocks_per_sm(plan.axis, int(plan.direction == "bwd"),
                                           int(dtype == torch.bfloat16), plan.smem,
                                           ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"shear occupancy query failed: CUDA error {err} ({plan})")
    return out.value


def fold_lanes(lanes: int, in_dims, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors of a `torch.func.vmap` rule with their lane axis folded into
    the batch: [lanes, B, ...] -> [lanes * B, ...], contiguous. A tensor whose
    in_dim is None (the same for every lane) is expanded to all lanes first."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(lanes, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.flatten(0, 1).contiguous())
    return out


class FractionalShiftFunction(torch.autograd.Function):
    """The shift through the CUDA kernels; the backward is one fused launch.

    Under `torch.func.vmap` the rule folds the lanes into the batch, so K lanes
    of [B, H, W] make one launch on [K * B, H, W]. Its gradients come from plain
    autograd outside the vmap (`loss.backward()`): under `torch.func.grad` the
    backward would get a functorch-wrapped cotangent, which has no data pointer
    to hand to the kernel.
    """

    @staticmethod
    def forward(x, delta, axis):
        return _launch_fwd(x, delta, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, delta, axis = inputs
        ctx.axis = axis
        ctx.save_for_backward(x, delta)

    @staticmethod
    def backward(ctx, g):
        x, delta = ctx.saved_tensors
        # where x needs no gradient (the first shift of the per-shear rotation,
        # on the data), the dx-free variant skips dx; d delta keeps its bits
        dx, ddelta = _launch_bwd(x, delta, g, ctx.axis, with_dx=ctx.needs_input_grad[0])
        return dx, ddelta.to(delta.dtype), None

    @staticmethod
    def vmap(info, in_dims, x, delta, axis):
        x, delta = fold_lanes(info.batch_size, in_dims[:2], x, delta)
        return FractionalShiftFunction.apply(x, delta, axis).unflatten(0, (info.batch_size, -1)), 0


def fractional_shift(x: torch.Tensor, delta: torch.Tensor, axis: int) -> torch.Tensor:
    """Shift x [B, H, W] by delta along `axis` (see the module docstring).

    CPU tensors take `fractional_shift_reference`; CUDA tensors launch the
    kernels or raise.
    """
    if x.device.type == "cpu":
        return fractional_shift_reference(x, delta, axis)
    if x.device.type == "cuda":
        return FractionalShiftFunction.apply(x, delta, axis)
    raise ValueError(f"fractional_shift runs on CPU or CUDA tensors, got {x.device}")
