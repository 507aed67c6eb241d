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
  giving dx (by the VJP formula) and d delta.
* `fractional_shift` dispatches on the device: CPU tensors take the plain
  version, CUDA tensors the kernels; there is no fallback from one to the
  other.

`FWD_LAUNCHES` and `BWD_LAUNCHES` count kernel launches, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "fractional_shift",
    "fractional_shift_reference",
    "fractional_shift_vjp_reference",
    "FractionalShiftFunction",
    "lerp_shift",
    "FWD_LAUNCHES",
    "BWD_LAUNCHES",
]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.livae_shear_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.livae_shear_fwd.restype = i
        lib.livae_shear_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.livae_shear_bwd.restype = i
        _SIGNED = True
    return lib


def _check(x: torch.Tensor, delta: torch.Tensor, axis: int) -> tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"shear kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"shear kernel takes float32 or bfloat16, got {x.dtype}")
    return _check_shapes(x, delta, axis)


def _launch_fwd(x: torch.Tensor, delta: torch.Tensor, axis: int) -> torch.Tensor:
    global FWD_LAUNCHES
    B, H, W = _check(x, delta, axis)
    lib = _lib()
    x = x.contiguous()
    delta = delta.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.livae_shear_fwd(x.data_ptr(), delta.data_ptr(), out.data_ptr(), B, H, W,
                                  axis, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"shear forward kernel launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out


def _launch_bwd(x: torch.Tensor, delta: torch.Tensor, g: torch.Tensor, axis: int):
    global BWD_LAUNCHES
    B, H, W = _check(x, delta, axis)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("shear backward: the cotangent must match x in shape, dtype and device")
    lib = _lib()
    x = x.contiguous()
    g = g.contiguous()
    delta = delta.float().contiguous()
    dx = torch.empty_like(x)
    ddelta = torch.empty_like(delta)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.livae_shear_bwd(x.data_ptr(), delta.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                  ddelta.data_ptr(), B, H, W, axis,
                                  int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"shear backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx, ddelta


class FractionalShiftFunction(torch.autograd.Function):
    """The shift through the CUDA kernels; the backward is one fused launch."""

    @staticmethod
    def forward(ctx, x, delta, axis):
        ctx.axis = axis
        ctx.save_for_backward(x, delta)
        return _launch_fwd(x, delta, axis)

    @staticmethod
    def backward(ctx, g):
        x, delta = ctx.saved_tensors
        dx, ddelta = _launch_bwd(x, delta, g, ctx.axis)
        return dx, ddelta.to(delta.dtype), None


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
