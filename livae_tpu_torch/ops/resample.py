"""Rotation by three shears on a padded canvas (port of livae_tpu/ops/resample.py).

Layout is NCHW: images are [B, C, H, W]. `rotate_image_fast` follows the STN
grid convention of the reference (the sampling grid rotates by theta, so the
content rotates by -theta): exact 90-degree turns reduce |phi| to pi/4, the
image is padded by `margin`, and `rot3` applies Sx(-tan(phi/2)) .
Sy(sin phi) . Sx(-tan(phi/2)) on the square canvas before the centre crop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .rot3 import rot3

__all__ = [
    "rotation_matrix",
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
) -> torch.Tensor:
    """Rotate img [B, 1, S, S] by the STN convention; theta [B] or [B, 1] radians.

    margin: canvas padding, default `aligned_margin(S)`. The output keeps the
    input dtype (rot3 works in float32 inside and casts once).
    """
    B, C, H, W = img.shape
    if H != W:
        raise ValueError("rotate_image_fast requires square images")
    if C != 1:
        raise ValueError("rotate_image_fast takes one channel")
    S = H
    theta = theta.reshape(-1).float()

    q = torch.round(theta / (math.pi / 2.0)).detach()
    phi = theta - q * (math.pi / 2.0)
    img = _rot90_select(img, q.long())

    if margin is None:
        margin = aligned_margin(S)
    img = _pad(img, margin, padding_mode)
    P = S + 2 * margin
    c = (P - 1) / 2.0

    alpha = -torch.tan(phi / 2.0)[:, None]  # [B, 1]
    beta = torch.sin(phi)[:, None]
    pos = torch.arange(P, dtype=torch.float32, device=img.device) - c  # [P]
    d_row = alpha * pos[None, :]  # per-row shift along W
    d_col = beta * pos[None, :]  # per-column shift along H

    out = rot3(img[:, 0], d_row, d_col)[:, None]
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
