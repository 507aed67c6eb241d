"""The plain reference of the dataset build: normalised frames and the
adaptive-lattice site table, in NumPy and SciPy on the host.

It follows the upstream LI-VAE dataset (band-pass 20-100, min-max, lattice
constant from the whitened FFT's radial profile, peaks at least
0.15 x spacing apart snapped to their 5x5 argmax, two local lattice vectors
per atom, the 8 predicted neighbours, dedupe at 0.35 x spacing, atom or
vacancy at 0.6 x spacing). The radial profile is taken in float64 here.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import fft as sfft
from scipy import ndimage
from scipy.signal import find_peaks
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def bandpass_normalize(image: np.ndarray, low: float = 20.0, high: float = 100.0) -> np.ndarray:
    """Annular FFT band-pass about (rows // 2, cols // 2), then min-max to [0, 1]."""
    a = np.asarray(image, dtype=np.float64)
    rows, cols = a.shape
    y = np.arange(rows)[:, None] - rows // 2
    x = np.arange(cols)[None, :] - cols // 2
    r = np.sqrt(x * x + y * y)
    mask = (r >= low) & (r <= high)
    out = np.real(sfft.ifft2(sfft.ifftshift(sfft.fftshift(sfft.fft2(a)) * mask)))
    ptp = np.ptp(out)
    return np.zeros_like(out) if ptp == 0.0 else (out - out.min()) / ptp


def lattice_constant(img: np.ndarray, min_atom: float = 10.0, max_atom: float = 60.0,
                     prominence: float = 0.1, sigma_frac: float = 0.005) -> float:
    """Spacing = size / radius of the first prominent peak of the whitened
    spectrum's radial mean; 15.0 where there is none."""
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape
    sigma = H * sigma_frac
    fy, fx = np.fft.fftfreq(H), np.fft.fftfreq(W)
    transfer = np.exp(-2.0 * (math.pi * sigma) ** 2 * (fy[:, None] ** 2 + fx[None, :] ** 2))
    whitened = img - np.real(np.fft.ifft2(np.fft.fft2(img) * transfer))
    magnitude = np.abs(np.fft.fftshift(np.fft.fft2(whitened)))
    y = np.arange(H)[:, None] - H // 2
    x = np.arange(W)[None, :] - W // 2
    radius = np.sqrt(x * x + y * y).astype(np.int64).ravel()
    keep = radius < H
    sums = np.bincount(radius[keep], weights=magnitude.ravel()[keep], minlength=H)[:H]
    counts = np.bincount(radius[keep], minlength=H)[:H]
    profile = sums / np.maximum(counts, 1)
    r_min = max(2, int(H / max_atom))
    r_max = min(len(profile) - 1, int(H / min_atom))
    band = profile[r_min:r_max + 1]
    peaks, _ = find_peaks(band, prominence=band.max() * prominence)
    return 15.0 if len(peaks) == 0 else float(H / (peaks[0] + r_min))


def clean_peaks(img: np.ndarray, min_distance: int, threshold_rel: float = 0.01) -> np.ndarray:
    """Local maxima over a (2d+1)^2 window above threshold_rel x max, off the
    border, strongest first and greedily at least d apart, each snapped to
    the argmax of its 5x5 neighbourhood."""
    size = 2 * min_distance + 1
    mask = img == ndimage.maximum_filter(img, size=size, mode="constant", cval=-np.inf)
    mask &= img > threshold_rel * float(img.max())
    if min_distance:
        inner = np.zeros_like(mask)
        inner[min_distance:-min_distance or None, min_distance:-min_distance or None] = True
        mask &= inner
    coords = np.column_stack(np.nonzero(mask))
    if len(coords) == 0:
        return coords.reshape(0, 2)
    coords = coords[np.argsort(img[coords[:, 0], coords[:, 1]])[::-1]]
    if min_distance > 1:
        near = cKDTree(coords).query_ball_point(coords, r=min_distance - 1e-9)
        gone = np.zeros(len(coords), bool)
        keep = np.zeros(len(coords), bool)
        for i in range(len(coords)):
            if not gone[i]:
                keep[i] = True
                gone[near[i]] = True
        coords = coords[keep]
    h, w = img.shape
    out = []
    for r, c in coords:
        r1, c1 = max(0, r - 2), max(0, c - 2)
        local = img[r1:min(h, r + 3), c1:min(w, c + 3)]
        li = np.unravel_index(np.argmax(local), local.shape)
        out.append([r1 + li[0], c1 + li[1]])
    return np.array(out)


def _lattice_vectors(atoms: np.ndarray, k: int = 7):
    """Per atom, the pair of its k-1 nearest-neighbour vectors with the
    largest |cross| / (|v1| |v2|); NaN rows where there is none."""
    n = len(atoms)
    k = min(k, n)
    if k < 3:
        nan = np.full((n, 2), np.nan)
        return nan, nan
    _, idx = cKDTree(atoms).query(atoms, k=k)
    vec = atoms[idx[:, 1:]] - atoms[:, None, :]
    ii, jj = np.triu_indices(vec.shape[1], k=1)
    v1, v2 = vec[:, ii], vec[:, jj]
    n1, n2 = np.linalg.norm(v1, axis=-1), np.linalg.norm(v2, axis=-1)
    cross = np.abs(v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0])
    score = np.where((n1 < 1e-6) | (n2 < 1e-6), -1.0, cross / np.maximum(n1 * n2, 1e-12))
    best = np.argmax(score, axis=1)
    rows = np.arange(n)
    b1, b2 = v1[rows, best], v2[rows, best]
    bad = score[rows, best] < 0
    b1[bad] = np.nan
    b2[bad] = np.nan
    return b1, b2


def _cluster(points: np.ndarray, radius: float) -> np.ndarray:
    """Centroids of the points' transitive clusters within `radius`, in the
    order of each cluster's first point."""
    n = len(points)
    pairs = cKDTree(points).query_pairs(r=radius, output_type="ndarray")
    if len(pairs):
        adj = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
        comp = connected_components(adj, directed=False)[1]
    else:
        comp = np.arange(n)
    _, first, inverse = np.unique(comp, return_index=True, return_inverse=True)
    order = np.argsort(first)
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    labels = remap[inverse]
    sums = np.zeros((labels.max() + 1, 2))
    np.add.at(sums, labels, points)
    return sums / np.bincount(labels)[:, None]


def site_table(img: np.ndarray, patch_size: int, padding: int,
               threshold: float = 0.6) -> tuple[np.ndarray, np.ndarray, float]:
    """(sites [N, 2] (y, x), labels [N] (1 atom, 0 vacancy), spacing) of one
    normalised frame."""
    spacing = lattice_constant(img)
    atoms = clean_peaks(img, int(spacing * 0.15)).astype(np.float64)
    half = patch_size // 2 + padding
    H, W = img.shape

    def inside(p):
        return (p[:, 0] >= half) & (p[:, 0] <= H - half) & (p[:, 1] >= half) & (p[:, 1] <= W - half)

    atoms = atoms[inside(atoms)] if len(atoms) else atoms
    if len(atoms) == 0:
        return np.zeros((0, 2)), np.zeros(0, np.int64), spacing
    v1, v2 = _lattice_vectors(atoms)
    ok = ~np.isnan(v1[:, 0])
    a, b1, b2 = atoms[ok], v1[ok], v2[ok]
    offsets = np.stack([b1, -b1, b2, -b2, b1 + b2, -(b1 + b2), b1 - b2, b2 - b1], axis=1)
    predicted = (a[:, None, :] + offsets).reshape(-1, 2)
    sites = _cluster(np.concatenate([atoms, predicted[inside(predicted)]]), spacing * 0.35)
    dist, _ = cKDTree(atoms).query(sites)
    return sites, (dist < spacing * threshold).astype(np.int64), spacing


def build(frames: list[np.ndarray], patch_size: int, padding: int):
    """(normalised frames [N, H, W] float32, image index [S], sites [S, 2]
    float32, spacings) of the frames, sites in frame order."""
    normed = [bandpass_normalize(f) for f in frames]
    tables = [site_table(f, patch_size, padding) for f in normed]
    img_idx = np.concatenate([np.full(len(t[0]), i, np.int64) for i, t in enumerate(tables)])
    sites = np.concatenate([t[0] for t in tables]).astype(np.float32)
    return (np.stack(normed).astype(np.float32), img_idx, sites,
            [t[2] for t in tables])
