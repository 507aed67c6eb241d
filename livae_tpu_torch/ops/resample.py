"""Rotation and bilinear resampling (port of livae_tpu/ops/resample.py).

Layout is NCHW: images are [B, C, H, W]; grids are [B, Ho, Wo, 2] with the
last axis (x, y) in [-1, 1], as `F.affine_grid` gives them.

* The exact resampler: `affine_grid`, `grid_sample` (align_corners=False;
  zeros, border and reflection padding), `sample_at_pixels` and
  `rotate_image`, PyTorch's grid sampler semantics. The JAX package composes
  them from XLA gathers; here `F.affine_grid` / `F.grid_sample` are the port,
  and `sample_at_pixels` is the same gather and lerp at pixel coordinates.
* `rotate_image_fast` follows the STN grid convention of `rotate_image` (the
  sampling grid rotates by theta, so the content rotates by -theta): exact
  90-degree turns reduce |phi| to pi/4, the image is padded by `margin`, and
  Sx(-tan(phi/2)) . Sy(sin phi) . Sx(-tan(phi/2)) runs on the square canvas
  before the centre crop, either as one fused rot3 or as three single shifts.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .rot3 import MAX_P, rot3
from .shear import fractional_shift

__all__ = [
    "rotation_matrix",
    "affine_grid",
    "grid_sample",
    "sample_at_pixels",
    "rotate_image",
    "aligned_margin",
    "rotate_image_fast",
    "center_crop",
]


def rotation_matrix(cos_theta: torch.Tensor, sin_theta: torch.Tensor) -> torch.Tensor:
    """2x3 pure-rotation affine matrices [B, 2, 3]: [[cos, -sin, 0], [sin, cos, 0]]."""
    cos_theta = cos_theta.reshape(-1)
    sin_theta = sin_theta.reshape(-1)
    zeros = torch.zeros_like(cos_theta)
    row1 = torch.stack([cos_theta, -sin_theta, zeros], dim=-1)
    row2 = torch.stack([sin_theta, cos_theta, zeros], dim=-1)
    return torch.stack([row1, row2], dim=1)


def affine_grid(theta: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Normalised sampling grid [B, H, W, 2] of 2x3 matrices theta [B, 2, 3]:
    `F.affine_grid(theta, (B, 1, H, W), align_corners=False)`."""
    H, W = size
    return F.affine_grid(theta.float(), [theta.shape[0], 1, H, W], align_corners=False)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros"
                ) -> torch.Tensor:
    """Bilinear sample of img [B, C, H, W] at grid [B, Ho, Wo, 2] with
    align_corners=False: `F.grid_sample`, [B, C, Ho, Wo]."""
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"Unknown padding_mode: {padding_mode}")
    return F.grid_sample(img, grid, mode="bilinear", padding_mode=padding_mode,
                         align_corners=False)


def _reflect_coordinates(coord: torch.Tensor, size: int) -> torch.Tensor:
    """PyTorch's reflection for align_corners=False: about -0.5 and size-0.5."""
    if size == 1:
        return torch.zeros_like(coord)
    span = float(size)
    c = torch.abs(coord + 0.5)
    extra = torch.remainder(c, span)
    flips = torch.floor(c / span)
    even = torch.remainder(flips, 2.0) == 0.0
    return torch.where(even, extra - 0.5, span - extra - 0.5)


def sample_at_pixels(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of img [B, C, H, W] at pixel coordinates ix, iy [B, ...]
    (x = column, y = row) -> [B, C, ...]. Zeros padding masks corners outside
    the image; border clamps; reflection reflects, then clamps."""
    B, C, H, W = img.shape
    out_shape = ix.shape[1:]
    ix = ix.reshape(B, -1).float()
    iy = iy.reshape(B, -1).float()
    if padding_mode == "reflection":
        ix = torch.clamp(_reflect_coordinates(ix, W), 0.0, W - 1)
        iy = torch.clamp(_reflect_coordinates(iy, H), 0.0, H - 1)
    elif padding_mode == "border":
        ix = torch.clamp(ix, 0.0, W - 1)
        iy = torch.clamp(iy, 0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"Unknown padding_mode: {padding_mode}")

    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(B, C, H * W)

    def corner(xc, yc, wx, wy):
        w = wx * wy
        if padding_mode == "zeros":
            valid = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
            w = torch.where(valid, w, torch.zeros_like(w))
        xi = torch.clamp(xc, 0.0, W - 1).long()
        yi = torch.clamp(yc, 0.0, H - 1).long()
        idx = (yi * W + xi)[:, None, :].expand(B, C, -1)
        return torch.gather(flat, 2, idx) * w[:, None, :]

    out = (corner(x0, y0, wx0, wy0) + corner(x1, y0, wx1, wy0)
           + corner(x0, y1, wx0, wy1) + corner(x1, y1, wx1, wy1))
    return out.reshape((B, C) + tuple(out_shape))


def rotate_image(img: torch.Tensor, theta: torch.Tensor, padding_mode: str = "reflection"
                 ) -> torch.Tensor:
    """Exact bilinear rotation of img [B, C, H, W] by the STN convention: the
    sampling grid rotates by theta [B] or [B, 1] radians."""
    theta = theta.reshape(-1)
    mat = rotation_matrix(torch.cos(theta), torch.sin(theta))
    return grid_sample(img, affine_grid(mat, img.shape[2:]), padding_mode)


def _rot90_select(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-sample exact rotation of the sampling grid by q*90deg (q in 0..3).

    img: [B, C, S, S]. R(90): out[y, x] = img[x, S-1-y].
    """
    r1 = torch.flip(img.transpose(2, 3), dims=(2,))
    r2 = torch.flip(img, dims=(2, 3))
    r3 = torch.flip(img.transpose(2, 3), dims=(3,))
    q = torch.remainder(q.reshape(-1), 4)[:, None, None, None]
    out = torch.where(q == 1, r1, img)
    out = torch.where(q == 2, r2, out)
    return torch.where(q == 3, r3, out)


def aligned_margin(size: int) -> int:
    """The JAX package's shear margin: the canvas is S + 2*(S//4) rounded up
    to a multiple of 128 (256 for S = 128). Kept as it is for parity."""
    canvas = -(-(size + 2 * (size // 4)) // 128) * 128
    return (canvas - size) // 2


def _pad(img: torch.Tensor, margin: int, padding_mode: str) -> torch.Tensor:
    """numpy.pad semantics on the last two axes ('reflect' may exceed S)."""
    if padding_mode == "zeros":
        return F.pad(img, (margin, margin, margin, margin))
    mode = {"reflection": "reflect", "border": "edge"}.get(padding_mode)
    if mode is None:
        raise ValueError(f"Unknown padding_mode: {padding_mode}")
    S = img.shape[-1]
    idx = torch.from_numpy(np.pad(np.arange(S), margin, mode=mode)).to(img.device)
    return img.index_select(-2, idx).index_select(-1, idx)


def rotate_image_fast(
    img: torch.Tensor,
    theta: torch.Tensor,
    padding_mode: str = "reflection",
    margin: int | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Rotate img [B, C, S, S] by the STN convention; theta [B] or [B, 1] radians.

    margin: canvas padding, default `aligned_margin(S)`. The output keeps the
    input dtype: both backends work in float32 and cast once.

    backend (the JAX package's name in brackets):
      * "fused" (pallas): one rot3 over the canvas. It takes one channel and a
        canvas of at most `rot3.MAX_P` (432: the kernels hold the canvas in a
        thread-block cluster's shared memory); other shapes raise.
      * "shear" (xla): the channels fold into the batch, and three single
        shifts run on the f32 canvas (`fractional_shift`).
      * "auto": "fused" where it takes the shape, else "shear", chosen from the
        shape before anything runs. Larger canvases thus take the per-shear
        path, as the JAX package sends canvases above its fused limit to XLA.
    In f32, and for bf16 input, the two give the same bits.
    """
    B, C, H, W = img.shape
    if H != W:
        raise ValueError("rotate_image_fast requires square images")
    if backend not in ("auto", "fused", "shear"):
        raise ValueError(f"rotate_image_fast backend must be auto, fused or shear, got {backend}")
    S = H
    if margin is None:
        margin = aligned_margin(S)
    P = S + 2 * margin
    fused_fits = C == 1 and P <= MAX_P
    if backend == "fused" and not fused_fits:
        raise ValueError(f"rotate_image_fast(backend='fused') takes one channel and a canvas "
                         f"up to {MAX_P}, got C={C}, canvas {P}; use 'shear' or 'auto'")
    use_fused = fused_fits if backend == "auto" else backend == "fused"
    theta = theta.reshape(-1).float()

    q = torch.round(theta / (math.pi / 2.0)).detach()
    phi = theta - q * (math.pi / 2.0)
    img = _rot90_select(img, q.long())
    img = _pad(img, margin, padding_mode)
    c = (P - 1) / 2.0

    alpha = -torch.tan(phi / 2.0)[:, None]  # [B, 1]
    beta = torch.sin(phi)[:, None]
    pos = torch.arange(P, dtype=torch.float32, device=img.device) - c  # [P]
    d_row = alpha * pos[None, :]  # per-row shift along W
    d_col = beta * pos[None, :]  # per-column shift along H

    if use_fused:
        out = rot3(img[:, 0], d_row, d_col)[:, None]
    else:
        v = img.reshape(B * C, P, P).float()
        d_row = d_row.repeat_interleave(C, dim=0)
        d_col = d_col.repeat_interleave(C, dim=0)
        v = fractional_shift(v, d_row, 2)  # Sx: along W, one shift per row
        v = fractional_shift(v, d_col, 1)  # Sy: along H, one shift per column
        v = fractional_shift(v, d_row, 2)
        out = v.to(img.dtype).reshape(B, C, P, P)
    return out[:, :, margin : margin + S, margin : margin + S]


def center_crop(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Centre-crop the last two axes to (h, w), torchvision's offsets
    (top = round((H - h) / 2)); zero-pads (floor on top/left) when the
    requested size exceeds the input."""
    h, w = size
    H, W = img.shape[-2], img.shape[-1]
    pad_h, pad_w = max(0, h - H), max(0, w - W)
    if pad_h or pad_w:
        img = F.pad(img, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        H, W = H + pad_h, W + pad_w
    top = int(round((H - h) / 2.0))
    left = int(round((W - w) / 2.0))
    return img[..., top : top + h, left : left + w]
