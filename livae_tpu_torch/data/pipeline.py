"""On-device patch extraction and augmentation (port of livae_tpu/data/pipeline.py).

Whole preprocessed frames live on the device; one call crops, sub-pixel
recentres, augments and normalises a batch of patches. The crop is a plain
gather (the JAX package's matmul and row-gather crops are TPU workarounds).

Augmentation draws (scale U(0.9, 1.1), h/v flips p=0.5, integer roll jitter
U{-4..4}, angle U(0, 2pi)) come from a torch.Generator, or are passed in
explicitly (`PairedDraws`) to reproduce another implementation's randomness.

Paired semantics: `rotated = rotate(patch, +angle)` in the STN grid
convention, so theta_rotated = theta_original - angle, the relation the
cycle-consistency loss expects. Patches come out NCHW, [B, 1, P, P].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.resample import rotate_image_fast

__all__ = [
    "AugmentConfig",
    "PairedDraws",
    "pad_frames",
    "sample_paired_draws",
    "extract_batch",
    "extract_batch_paired",
    "extract_batch_paired_with_draws",
]


@dataclass(frozen=True)
class AugmentConfig:
    """Augmentation configuration (the reference's default_transform)."""

    scale_min: float = 0.9
    scale_max: float = 1.1
    flip_prob: float = 0.5
    jitter: int = 4
    rotation: bool = False


@dataclass(frozen=True)
class PairedDraws:
    """One batch's augmentation draws, each [B] on the batch's device."""

    scale: torch.Tensor
    flip_h: torch.Tensor
    flip_v: torch.Tensor
    jy: torch.Tensor
    jx: torch.Tensor
    angle: torch.Tensor


def pad_frames(frames: torch.Tensor, margin: int) -> torch.Tensor:
    """Zero-pad [N, H, W] frames so ROI crops never clamp at the borders."""
    return F.pad(frames, (margin, margin, margin, margin))


def _default_margin(patch_size: int, padding: int) -> tuple[int, int, int]:
    P2 = patch_size + 2 * padding
    roi = P2 + 16
    return P2, roi, roi // 2 + 8


def _crop_starts(cy, cx, roi: int, margin: int, padded_shape):
    """Clamped integer crop origins (padded-frame coords) and the sub-pixel
    residuals of the unclamped origins."""
    y_int = torch.round(cy).long()
    x_int = torch.round(cx).long()
    y0 = torch.clamp(y_int - roi // 2 + margin, 0, padded_shape[0] - roi)
    x0 = torch.clamp(x_int - roi // 2 + margin, 0, padded_shape[1] - roi)
    ry = cy - (y_int - roi // 2).to(cy.dtype)
    rx = cx - (x_int - roi // 2).to(cx.dtype)
    return y0, x0, ry, rx


def _crop_rois(frames_padded, img_idx, cy, cx, roi: int, margin: int):
    """Batched ROI crop around rounded centres: (rois [B, roi, roi], ry, rx)."""
    y0, x0, ry, rx = _crop_starts(cy, cx, roi, margin, frames_padded.shape[1:3])
    ar = torch.arange(roi, device=frames_padded.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    rois = frames_padded[img_idx.long()[:, None, None], rows, cols]
    return rois, ry, rx


def _minmax_normalize(p: torch.Tensor) -> torch.Tensor:
    """Per-patch min-max of [B, H, W] to [0, 1]; a constant patch -> zeros."""
    mn = p.amin(dim=(1, 2), keepdim=True)
    mx = p.amax(dim=(1, 2), keepdim=True)
    rng_ = mx - mn
    pos = rng_ > 0
    return torch.where(pos, (p - mn) / torch.where(pos, rng_, torch.ones_like(rng_)),
                       torch.zeros_like(p))


def _axis_resample(x: torch.Tensor, src: torch.Tensor, dim: int) -> torch.Tensor:
    """1-D bilinear resample of x [B, H, W] along `dim` at source coords
    src [B, n_out] (zero outside the input)."""
    n = x.shape[dim]
    i0f = torch.floor(src)
    f = src - i0f
    i0 = i0f.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 <= n - 1), 1.0 - f, torch.zeros_like(f))
    w1 = torch.where((i1 >= 0) & (i1 <= n - 1), f, torch.zeros_like(f))
    i0c = torch.clamp(i0, 0, n - 1)
    i1c = torch.clamp(i1, 0, n - 1)
    if dim == 1:  # [B, n_out] indices broadcast along W
        idx0, idx1 = (i[:, :, None].expand(-1, -1, x.shape[2]) for i in (i0c, i1c))
        w0, w1 = w0[:, :, None], w1[:, :, None]
    else:  # broadcast along H
        idx0, idx1 = (i[:, None, :].expand(-1, x.shape[1], -1) for i in (i0c, i1c))
        w0, w1 = w0[:, None, :], w1[:, None, :]
    return torch.gather(x, dim, idx0) * w0 + torch.gather(x, dim, idx1) * w1


def _scale_translate(rois, ry, rx, out_size: int, scale, flip_h, flip_v, jy, jx):
    """Separable resample onto an `out_size` grid with the atom at out_size/2,
    scaled about it, with the flips and roll jitter folded into the grid."""
    c_out = out_size / 2.0
    grid = torch.arange(out_size, device=rois.device)[None, :]

    def src_for(r, flip, j):
        m = torch.remainder(grid - j[:, None], out_size)  # torch.roll(shifts=j)
        m = torch.where(flip[:, None], out_size - 1 - m, m)
        return (m.float() - c_out) / scale[:, None] + r[:, None]

    out = _axis_resample(rois, src_for(ry, flip_v, jy), dim=1)
    return _axis_resample(out, src_for(rx, flip_h, jx), dim=2)


def _center_crop_b(p: torch.Tensor, size: int) -> torch.Tensor:
    R = p.shape[1]
    top = int(round((R - size) / 2.0))
    return p[:, top : top + size, top : top + size]


def sample_paired_draws(B: int, cfg: AugmentConfig | None, generator: torch.Generator,
                        device) -> PairedDraws:
    """Draw one batch's augmentation values from `generator` (on `device`).

    cfg=None keeps scale 1, no flips and no jitter; the angle is always drawn.
    """
    kw = dict(generator=generator, device=device)
    if cfg is not None:
        scale = cfg.scale_min + (cfg.scale_max - cfg.scale_min) * torch.rand(B, **kw)
        flip_h = torch.rand(B, **kw) < cfg.flip_prob
        flip_v = torch.rand(B, **kw) < cfg.flip_prob
        jy = torch.randint(-cfg.jitter, cfg.jitter + 1, (B,), **kw)
        jx = torch.randint(-cfg.jitter, cfg.jitter + 1, (B,), **kw)
    else:
        scale = torch.ones(B, device=device)
        flip_h = flip_v = torch.zeros(B, dtype=torch.bool, device=device)
        jy = jx = torch.zeros(B, dtype=torch.long, device=device)
    angle = 2 * math.pi * torch.rand(B, **kw)
    return PairedDraws(scale, flip_h, flip_v, jy, jx, angle)


def extract_batch_paired_with_draws(
    frames_padded: torch.Tensor,
    img_idx: torch.Tensor,
    centers: torch.Tensor,
    draws: PairedDraws,
    patch_size: int,
    padding: int = 48,
    margin: int | None = None,
    normalize: bool = True,
    rot_dtype: str | None = None,
):
    """Paired extraction with explicit draws: (patch, rotated, angle).

    The non-rotation augmentation runs on the padded patch; the rotated copy
    is `rotate_image_fast` of it by +angle on a zero-padded canvas (margin
    P2 // 6, the JAX package's choice) in `rot_dtype`; both are centre-cropped
    and, with `normalize`, min-max normalised on their own.
    """
    P2, roi, default_margin = _default_margin(patch_size, padding)
    if margin is None:
        margin = default_margin
    rois, ry, rx = _crop_rois(frames_padded, img_idx, centers[:, 0], centers[:, 1], roi, margin)
    p_big = _scale_translate(rois, ry, rx, P2, draws.scale, draws.flip_h, draws.flip_v,
                             draws.jy, draws.jx)
    rot_in = p_big[:, None]
    if rot_dtype is not None:
        rot_in = rot_in.to(getattr(torch, rot_dtype))
    rot_big = rotate_image_fast(rot_in, draws.angle, padding_mode="zeros", margin=P2 // 6)[:, 0]

    patch = _center_crop_b(p_big, patch_size)
    rotated = _center_crop_b(rot_big, patch_size)
    if normalize:
        patch = _minmax_normalize(patch)
        rotated = _minmax_normalize(rotated)
    return patch[:, None], rotated[:, None], draws.angle


def extract_batch_paired(
    frames_padded, img_idx, centers, generator: torch.Generator, patch_size: int,
    padding: int = 48, cfg: AugmentConfig | None = AugmentConfig(),
    margin: int | None = None, normalize: bool = True, rot_dtype: str | None = None,
):
    """Paired extraction with draws from `generator`: (patch, rotated, angle)."""
    draws = sample_paired_draws(img_idx.shape[0], cfg, generator, frames_padded.device)
    return extract_batch_paired_with_draws(
        frames_padded, img_idx, centers, draws, patch_size, padding, margin, normalize,
        rot_dtype,
    )


def extract_batch(
    frames_padded, img_idx, centers, patch_size: int, padding: int = 48,
    normalize: bool = True, margin: int | None = None,
):
    """Un-augmented extraction (the encode path): [B, 1, P, P] float32."""
    P2, roi, default_margin = _default_margin(patch_size, padding)
    if margin is None:
        margin = default_margin
    B = img_idx.shape[0]
    rois, ry, rx = _crop_rois(frames_padded, img_idx, centers[:, 0], centers[:, 1], roi, margin)
    dev = frames_padded.device
    no_flip = torch.zeros(B, dtype=torch.bool, device=dev)
    no_jit = torch.zeros(B, dtype=torch.long, device=dev)
    p = _scale_translate(rois, ry, rx, P2, torch.ones(B, device=dev), no_flip, no_flip,
                         no_jit, no_jit)
    p = _center_crop_b(p, patch_size)
    if normalize:
        p = _minmax_normalize(p)
    return p[:, None]
