"""Host atom-peak detection for the dataset build (a copy of `peak_local_max`
and `get_clean_peaks`, livae_tpu/ops/peaks.py:43-130)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.spatial import cKDTree

__all__ = ["peak_local_max", "get_clean_peaks"]


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
