"""Fused 3-shear rotation y = Sx(d_row) . Sy(d_col) . Sx(d_row) . x.

Port of livae_tpu/ops/pallas/rot3.py. Each S is a mod-P lerp shift
out[i] = (1-f) in[(i+k) mod P] + f in[(i+k+1) mod P], k = floor(d), f = d - k,
with d constant along the shifted axis (Sx: along W, one d_row per row; Sy:
along H, one d_col per column). Intermediates stay float32; the result is cast
once to the input dtype.

* `rot3_reference` is the plain PyTorch version: direct index gathers, and its
  gradients come from autograd.
* `Rot3Function` launches the hand-written CUDA kernels (ops/csrc/rot3.cu):
  one forward launch, one fused backward launch giving dx, d d_row and d d_col.
* `rot3` dispatches on the device: CPU tensors take the plain version, CUDA
  tensors the kernels; there is no fallback from one to the other.

`FWD_LAUNCHES` and `BWD_LAUNCHES` count kernel launches, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rot3", "rot3_reference", "Rot3Function", "FWD_LAUNCHES", "BWD_LAUNCHES"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_MAX_P = 768  # the kernels' limit (ops/csrc/rot3.cu, kMaxP)


def _lerp_shift(v: torch.Tensor, delta: torch.Tensor, dim: int) -> torch.Tensor:
    """out = (1-f) v[(i+k) mod P] + f v[(i+k+1) mod P] along `dim` of [B, P, P].

    delta: [B, P], one shift per row (dim=2) or per column (dim=1).
    """
    P = v.shape[dim]
    k = torch.floor(delta).detach()
    f = delta - k
    ar = torch.arange(P, device=v.device)
    if dim == 2:
        i0 = torch.remainder(ar[None, None, :] + k.long()[:, :, None], P)
        f = f[:, :, None]
    else:
        i0 = torch.remainder(ar[None, :, None] + k.long()[:, None, :], P)
        f = f[:, None, :]
    i1 = torch.remainder(i0 + 1, P)
    g0 = torch.gather(v, dim, i0)
    g1 = torch.gather(v, dim, i1)
    return (1.0 - f) * g0 + f * g1


def rot3_reference(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch rot3: x [B, P, P], d_row/d_col [B, P] -> like x."""
    v = x.float()
    v = _lerp_shift(v, d_row.float(), 2)
    v = _lerp_shift(v, d_col.float(), 1)
    v = _lerp_shift(v, d_row.float(), 2)
    return v.to(x.dtype)


_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = _build.load("rot3")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.livae_rot3_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.livae_rot3_fwd.restype = i
        lib.livae_rot3_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.livae_rot3_bwd.restype = i
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
    if not 2 <= P <= _MAX_P:
        raise ValueError(f"rot3 kernel canvas must be 2..{_MAX_P}, got {P}")
    for name, d in (("d_row", d_row), ("d_col", d_col)):
        if d.shape != (B, P) or d.device != x.device:
            raise ValueError(f"{name} must be [{B}, {P}] on {x.device}, got "
                             f"{tuple(d.shape)} on {d.device}")
    return B, P


def _launch_fwd(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> torch.Tensor:
    global FWD_LAUNCHES
    B, P = _check(x, d_row, d_col)
    lib = _lib()
    x = x.contiguous()
    d_row = d_row.float().contiguous()
    d_col = d_col.float().contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty((B, P, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.livae_rot3_fwd(
            x.data_ptr(), d_row.data_ptr(), d_col.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, P, int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"rot3 forward kernel launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out


def _launch_bwd(x, d_row, d_col, g):
    global BWD_LAUNCHES
    B, P = _check(x, d_row, d_col)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("rot3 backward: the cotangent must match x in shape, dtype and device")
    lib = _lib()
    x = x.contiguous()
    g = g.contiguous()
    d_row = d_row.float().contiguous()
    d_col = d_col.float().contiguous()
    dx = torch.empty_like(x)
    ddr = torch.empty((B, P), dtype=torch.float32, device=x.device)
    ddc = torch.empty((B, P), dtype=torch.float32, device=x.device)
    scratch = torch.empty((3, B, P, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.livae_rot3_bwd(
            x.data_ptr(), d_row.data_ptr(), d_col.data_ptr(), g.data_ptr(),
            dx.data_ptr(), ddr.data_ptr(), ddc.data_ptr(), scratch.data_ptr(),
            B, P, int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"rot3 backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx, ddr, ddc


class Rot3Function(torch.autograd.Function):
    """rot3 through the CUDA kernels; the backward is the fused VJP kernel."""

    @staticmethod
    def forward(ctx, x, d_row, d_col):
        ctx.save_for_backward(x, d_row, d_col)
        return _launch_fwd(x, d_row, d_col)

    @staticmethod
    def backward(ctx, g):
        x, d_row, d_col = ctx.saved_tensors
        dx, ddr, ddc = _launch_bwd(x, d_row, d_col, g)
        return dx, ddr.to(d_row.dtype), ddc.to(d_col.dtype)


def rot3(x: torch.Tensor, d_row: torch.Tensor, d_col: torch.Tensor) -> torch.Tensor:
    """Fused 3-shear rotation of x [B, P, P] by per-row/per-column shifts [B, P].

    CPU tensors take `rot3_reference`; CUDA tensors launch the kernels or raise.
    """
    if x.device.type == "cpu":
        return rot3_reference(x, d_row, d_col)
    if x.device.type == "cuda":
        return Rot3Function.apply(x, d_row, d_col)
    raise ValueError(f"rot3 runs on CPU or CUDA tensors, got {x.device}")
