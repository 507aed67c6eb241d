"""Atom-peak detection (port of livae_tpu/ops/peaks.py).

* `peak_local_max` / `get_clean_peaks`: the host versions for the dataset
  build (copies of livae_tpu/ops/peaks.py:43-130), skimage's semantics.
* `peak_local_max_device` / `refine_peaks_device` / `detect_peaks_device`:
  the same detection as tensor ops on the image's device: max-pool NMS, the
  relative threshold and the border mask, then the `max_peaks` strongest
  candidates in a fixed-size table with a validity mask, and the snap of each
  peak to the argmax of its 5x5 window. The JAX names (`*_tpu`) are aliases.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from scipy.spatial import cKDTree

from ..device import resolve_device

__all__ = [
    "peak_local_max",
    "get_clean_peaks",
    "peak_local_max_device",
    "refine_peaks_device",
    "detect_peaks_device",
    "peak_local_max_tpu",
    "refine_peaks_tpu",
    "detect_peaks_tpu",
]


def peak_local_max(
    img: np.ndarray,
    min_distance: int = 1,
    threshold_rel: float | None = None,
    threshold_abs: float | None = None,
    exclude_border: bool | int = True,
) -> np.ndarray:
    """skimage.feature.peak_local_max-compatible peak finder.

    (N, 2) (row, col) coordinates sorted by descending intensity, at least
    `min_distance` apart, with skimage's default border exclusion.
    """
    img = np.asarray(img)
    size = 2 * min_distance + 1
    max_filt = ndimage.maximum_filter(img, size=size, mode="constant", cval=-np.inf)
    mask = img == max_filt

    thresholds = []
    if threshold_abs is not None:
        thresholds.append(threshold_abs)
    if threshold_rel is not None:
        thresholds.append(threshold_rel * float(img.max()))
    if thresholds:
        mask &= img > max(thresholds)

    border = min_distance if exclude_border is True else int(exclude_border)
    if border:
        inner = np.zeros_like(mask)
        inner[border:-border or None, border:-border or None] = True
        mask &= inner

    coords = np.column_stack(np.nonzero(mask))
    if len(coords) == 0:
        return coords.reshape(0, 2)

    order = np.argsort(img[coords[:, 0], coords[:, 1]])[::-1]
    coords = coords[order]
    if min_distance > 1:
        # greedy suppression in intensity order (skimage's ensure_spacing)
        tree = cKDTree(coords)
        neighborhoods = tree.query_ball_point(coords, r=min_distance - 1e-9)
        suppressed = np.zeros(len(coords), dtype=bool)
        keep = np.zeros(len(coords), dtype=bool)
        for i in range(len(coords)):
            if suppressed[i]:
                continue
            keep[i] = True
            suppressed[neighborhoods[i]] = True
        coords = coords[keep]
    return coords


def get_clean_peaks(
    img: np.ndarray, min_distance: int = 5, threshold_rel: float = 0.01
) -> np.ndarray:
    """Detect peaks and snap each to the argmax of its 5x5 neighbourhood."""
    img = np.asarray(img)
    coords = peak_local_max(img, min_distance=min_distance, threshold_rel=threshold_rel)
    if len(coords) == 0:
        return coords

    h, w = img.shape
    refined = []
    for r, c in coords:
        r_i, c_i = int(r), int(c)
        r1, r2 = max(0, r_i - 2), min(h, r_i + 3)
        c1, c2 = max(0, c_i - 2), min(w, c_i + 3)
        local = img[r1:r2, c1:c2]
        li = np.unravel_index(np.argmax(local), local.shape)
        refined.append([r1 + li[0], c1 + li[1]])
    return np.array(refined)


def _as_image(img, device) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to `device` (CUDA
    unless asked otherwise) as float64 if it is float64, else float32. The
    JAX versions see float32 (no x64); a float64 frame keeps its precision
    here, so the candidates and their order are the host detection's."""
    if isinstance(img, torch.Tensor):
        return img
    img = np.asarray(img)
    dtype = np.float64 if img.dtype == np.float64 else np.float32
    return torch.tensor(img.astype(dtype, copy=False), device=resolve_device(device))


def peak_local_max_device(
    img,
    min_distance: int = 5,
    threshold_rel: float = 0.01,
    max_peaks: int = 4096,
    exclude_border: bool = True,
    *,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Peak detection as tensor ops: max-pool NMS, threshold, strongest first.

    A pixel is a candidate where it equals the maximum of its
    (2*min_distance+1)^2 window (max_pool2d pads with -inf) and exceeds
    threshold_rel * max(img); with exclude_border, no candidate lies within
    min_distance of the edge. Candidates are ranked by intensity with a
    stable sort, so equal intensities keep the lower flat index first (the
    order of XLA's top_k), and the first `max_peaks` fill the table.

    Returns coords [max_peaks, 2] int32 (row, col), 0 where invalid, and
    valid [max_peaks] bool.
    """
    img = _as_image(img, device)
    H, W = img.shape
    pooled = F.max_pool2d(img[None, None], 2 * min_distance + 1, stride=1,
                          padding=min_distance)[0, 0]
    is_peak = (img == pooled) & (img > threshold_rel * img.max())
    if exclude_border and min_distance > 0:
        rows = torch.arange(H, device=img.device)[:, None]
        cols = torch.arange(W, device=img.device)[None, :]
        is_peak &= ((rows >= min_distance) & (rows < H - min_distance)
                    & (cols >= min_distance) & (cols < W - min_distance))

    score = torch.where(is_peak, img, torch.full_like(img, -torch.inf)).reshape(-1)
    top_vals, top_idx = torch.sort(score, descending=True, stable=True)
    top_vals, top_idx = top_vals[:max_peaks], top_idx[:max_peaks]
    if len(top_vals) < max_peaks:  # a table larger than the image: invalid rows
        pad = max_peaks - len(top_vals)
        top_vals = F.pad(top_vals, (0, pad), value=-torch.inf)
        top_idx = F.pad(top_idx, (0, pad))
    valid = torch.isfinite(top_vals)
    coords = torch.stack([top_idx // W, top_idx % W], dim=-1).to(torch.int32)
    return torch.where(valid[:, None], coords, 0), valid


def refine_peaks_device(img, coords: torch.Tensor, valid: torch.Tensor, *,
                        device=None) -> torch.Tensor:
    """Snap each peak to the first argmax of its 5x5 window, the window
    shifted to stay inside the image ([0, H-5] x [0, W-5]); 0 where invalid."""
    img = _as_image(img, device)
    H, W = img.shape
    c = coords.long()
    r0 = torch.clamp(c[:, 0] - 2, 0, H - 5)
    c0 = torch.clamp(c[:, 1] - 2, 0, W - 5)
    offs = torch.arange(5, device=img.device)
    win = img[(r0[:, None] + offs)[:, :, None], (c0[:, None] + offs)[:, None, :]]  # [N, 5, 5]
    flat = torch.argmax(win.reshape(-1, 25), dim=1)  # the first maximum
    refined = torch.stack([r0 + flat // 5, c0 + flat % 5], dim=-1).to(torch.int32)
    return torch.where(valid[:, None], refined, 0)


def detect_peaks_device(
    img,
    min_distance: int = 5,
    threshold_rel: float = 0.01,
    max_peaks: int = 4096,
    *,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NMS and the 5x5 refinement on the device: (refined coords, valid)."""
    img = _as_image(img, device)
    coords, valid = peak_local_max_device(img, min_distance=min_distance,
                                          threshold_rel=threshold_rel, max_peaks=max_peaks)
    return refine_peaks_device(img, coords, valid), valid


# the JAX package's names
peak_local_max_tpu = peak_local_max_device
refine_peaks_tpu = refine_peaks_device
detect_peaks_tpu = detect_peaks_device
