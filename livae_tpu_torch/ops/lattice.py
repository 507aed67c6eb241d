"""Lattice-constant estimation and adaptive lattice sites (port of
livae_tpu/ops/lattice.py:53-272, host peak detection only).

* `estimate_lattice_constant`: Fourier-domain Gaussian pre-whitening, FFT
  magnitude and radial profile in torch.fft on `device`; the 1-D peak search
  runs on the host.
* `build_adaptive_lattice`: detect atoms, pick two local lattice vectors per
  atom from its nearest neighbours, extrapolate the 8 surrounding sites, dedupe
  at 0.35 * spacing and label atom (1) or vacancy (0).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.signal import find_peaks
from scipy.spatial import cKDTree

from ..device import resolve_device
from .peaks import get_clean_peaks

__all__ = ["estimate_lattice_constant", "build_adaptive_lattice"]


def _whitened_radial_profile(img: torch.Tensor, sigma_frac: float = 0.005) -> torch.Tensor:
    """Blur-subtract (in the Fourier domain), FFT magnitude, radial mean."""
    img = img.float()
    H, W = img.shape
    sigma = H * sigma_frac
    fy = torch.fft.fftfreq(H, device=img.device)
    fx = torch.fft.fftfreq(W, device=img.device)
    transfer = torch.exp(-2.0 * (math.pi * sigma) ** 2 * (fy[:, None] ** 2 + fx[None, :] ** 2))
    background = torch.fft.ifft2(torch.fft.fft2(img) * transfer).real
    whitened = img - background
    magnitude = torch.fft.fftshift(torch.fft.fft2(whitened)).abs()

    y = torch.arange(H, dtype=torch.float32, device=img.device)[:, None] - H // 2
    x = torch.arange(W, dtype=torch.float32, device=img.device)[None, :] - W // 2
    radius = torch.sqrt(x * x + y * y).to(torch.int64).reshape(-1)
    keep = radius < H  # the JAX segment_sum drops ids >= num_segments
    radius, flat_m = radius[keep], magnitude.reshape(-1)[keep]
    radial_sum = torch.zeros(H, device=img.device).index_add_(0, radius, flat_m)
    radial_count = torch.bincount(radius, minlength=H).float()
    return radial_sum / torch.clamp(radial_count, min=1.0)


def estimate_lattice_constant(
    image,
    min_atom_size: float = 10.0,
    max_atom_size: float = 60.0,
    prominence_factor: float = 0.1,
    *,
    device=None,
) -> float:
    """Lattice spacing in pixels from the FFT radial profile; 15.0 if no peak.

    The search band is [img/max_atom_size, img/min_atom_size]; the first
    prominent peak's radius r gives spacing = img_size / r.
    """
    dev = resolve_device(device)
    image = np.asarray(image)
    img_size = image.shape[0]
    radial_profile = _whitened_radial_profile(
        torch.as_tensor(image, dtype=torch.float32, device=dev)
    ).cpu().numpy()

    search_r_min = max(2, int(img_size / max_atom_size))
    search_r_max = min(len(radial_profile) - 1, int(img_size / min_atom_size))
    profile_slice = radial_profile[search_r_min : search_r_max + 1]
    max_val = np.max(profile_slice)
    peaks, _ = find_peaks(profile_slice, prominence=max_val * prominence_factor)
    if len(peaks) == 0:
        return 15.0
    return float(img_size / (peaks[0] + search_r_min))


def _best_lattice_vectors(atoms: np.ndarray, k: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Per atom, the pair of its k-1 nearest-neighbour vectors with the largest
    |cross(v1, v2)| / (|v1||v2|). Rows are NaN where no valid pair exists."""
    n = len(atoms)
    k = min(k, n)
    tree = cKDTree(atoms)
    _, idx = tree.query(atoms, k=k)
    if k < 3:
        nanv = np.full((n, 2), np.nan)
        return nanv, nanv

    vectors = atoms[idx[:, 1:]] - atoms[:, None, :]  # [N, k-1, 2]
    m = vectors.shape[1]
    ii, jj = np.triu_indices(m, k=1)
    v1 = vectors[:, ii, :]
    v2 = vectors[:, jj, :]
    n1 = np.linalg.norm(v1, axis=-1)
    n2 = np.linalg.norm(v2, axis=-1)
    cross = np.abs(v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0])
    denom = n1 * n2
    indep = np.where((n1 < 1e-6) | (n2 < 1e-6), -1.0, cross / np.maximum(denom, 1e-12))
    best = np.argmax(indep, axis=1)
    rows = np.arange(n)
    bv1 = v1[rows, best]
    bv2 = v2[rows, best]
    invalid = indep[rows, best] < 0
    bv1[invalid] = np.nan
    bv2[invalid] = np.nan
    return bv1, bv2


def build_adaptive_lattice(
    img: np.ndarray,
    patch_size: int,
    padding: int = 48,
    detection_threshold: float = 0.6,
    lattice_spacing: float | None = None,
    atom_coords: np.ndarray | None = None,
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Adaptive-lattice site table of one preprocessed frame:
    (sites [N, 2] float64 (y, x), labels [N] int64, lattice_spacing).
    `device` is used only to estimate the spacing when it is not given."""
    img = np.asarray(img)
    if lattice_spacing is None:
        lattice_spacing = estimate_lattice_constant(img, device=device)
    if atom_coords is None:
        atom_coords = get_clean_peaks(img, min_distance=int(lattice_spacing * 0.15))

    half_patch = patch_size // 2 + padding
    if len(atom_coords) == 0:
        return np.zeros((0, 2)), np.zeros((0,), dtype=np.int64), lattice_spacing

    edge_mask = (
        (atom_coords[:, 0] >= half_patch)
        & (atom_coords[:, 0] <= img.shape[0] - half_patch)
        & (atom_coords[:, 1] >= half_patch)
        & (atom_coords[:, 1] <= img.shape[1] - half_patch)
    )
    atoms = atom_coords[edge_mask].astype(np.float64)
    if len(atoms) == 0:
        return np.zeros((0, 2)), np.zeros((0,), dtype=np.int64), lattice_spacing

    threshold_dist = lattice_spacing * detection_threshold
    v1, v2 = _best_lattice_vectors(atoms)
    valid = ~np.isnan(v1[:, 0])
    a, b1, b2 = atoms[valid], v1[valid], v2[valid]
    # 8 surrounding sites: +-v1, +-v2, +-(v1+v2), +-(v1-v2)
    offsets = np.stack(
        [b1, -b1, b2, -b2, b1 + b2, -(b1 + b2), b1 - b2, b2 - b1], axis=1
    )  # [M, 8, 2]
    predicted = (a[:, None, :] + offsets).reshape(-1, 2)
    in_bounds = (
        (predicted[:, 0] >= half_patch)
        & (predicted[:, 0] <= img.shape[0] - half_patch)
        & (predicted[:, 1] >= half_patch)
        & (predicted[:, 1] <= img.shape[1] - half_patch)
    )
    predicted_sites = np.concatenate([atoms, predicted[in_bounds]], axis=0)

    from .native import cluster_points, label_sites

    _, unique_sites = cluster_points(predicted_sites, lattice_spacing * 0.35)
    labels = label_sites(unique_sites, atoms, threshold_dist)
    return unique_sites, labels, lattice_spacing
