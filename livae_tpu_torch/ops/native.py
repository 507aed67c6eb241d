"""ctypes bindings for the native host library (native/lattice_native.cpp).

A copy of livae_tpu/ops/native.py: `native_available`, `cluster_points` (grid-hash + union-find
site dedup with centroids) and `label_sites` (atom/vacancy labels), built on
first use with `make -C native`, with a scipy fallback that gives the same
results when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "cluster_points", "label_sites"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liblattice_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True, timeout=120
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    lib.cluster_points.restype = ctypes.c_int32
    lib.cluster_points.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.label_sites.restype = None
    lib.label_sites.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return _load() is not None


def cluster_points(points: np.ndarray, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Cluster points within `radius` (transitively): (labels, centroids)."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = len(points)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros((0, 2))

    lib = _load()
    if lib is not None:
        labels = np.empty(n, dtype=np.int32)
        centroids = np.empty((n, 2), dtype=np.float64)
        n_clusters = lib.cluster_points(
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            float(radius),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if n_clusters >= 0:
            return labels, centroids[:n_clusters].copy()

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    pairs = tree.query_pairs(r=radius, output_type="ndarray")
    if len(pairs):
        adj = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
        _, comp = connected_components(adj, directed=False)
    else:
        comp = np.arange(n)
    # relabel by first occurrence to match the native ordering
    _, first_idx, inverse = np.unique(comp, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    labels = remap[inverse].astype(np.int32)
    n_clusters = labels.max() + 1
    sums = np.zeros((n_clusters, 2))
    np.add.at(sums, labels, points)
    counts = np.bincount(labels, minlength=n_clusters).astype(np.float64)
    return labels, sums / counts[:, None]


def label_sites(sites: np.ndarray, atoms: np.ndarray, threshold: float) -> np.ndarray:
    """1 where a detected atom lies within `threshold` of the site, else 0."""
    sites = np.ascontiguousarray(sites, dtype=np.float64)
    atoms = np.ascontiguousarray(atoms, dtype=np.float64)
    n, m = len(sites), len(atoms)
    if n == 0:
        return np.zeros(0, np.int64)
    if m == 0:
        return np.zeros(n, np.int64)

    lib = _load()
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.label_sites(
            sites.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            atoms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            m,
            float(threshold),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    from scipy.spatial import cKDTree

    dist, _ = cKDTree(atoms).query(sites)
    return (dist < threshold).astype(np.int64)
