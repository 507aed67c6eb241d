"""Synthetic MoS2 HAADF-STEM frame generator.

The reference repo's real data (data/HAADF1-3.h5, 2048x2048 HAADF frames of
MoS2 monolayers) is git-LFS and absent from the snapshot
(reference .MISSING_LARGE_BLOBS), so the rebuild synthesizes physically
shaped stand-ins: a honeycomb lattice with a bright Mo sublattice and a
dimmer S2 sublattice (HAADF Z-contrast), Gaussian atomic columns, random
sulfur vacancies, Poisson-ish noise, and a slow illumination background.
Tests also use the reference's simpler 3-plane-wave hexagonal fixture
(reference tests/test_utils.py:6-22).
"""

from __future__ import annotations

import numpy as np

__all__ = ["hexagonal_wave_image", "synthetic_mos2_frame", "save_frame_h5"]


def hexagonal_wave_image(
    size: int = 256,
    spacing: float = 16.0,
    noise: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """3 plane waves at 120 deg + Gaussian noise (reference tests/test_utils.py:6-22)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:size, :size].astype(np.float64)
    k = 2 * np.pi / spacing
    img = np.zeros((size, size))
    for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3):
        img += np.cos(k * (np.cos(a) * x + np.sin(a) * y))
    img += rng.normal(0, noise, img.shape)
    return img


def synthetic_mos2_frame(
    size: int = 2048,
    spacing: float = 16.0,
    vacancy_rate: float = 0.03,
    mo_vacancy_rate: float = 0.0,
    rotation_deg: float = 7.0,
    noise: float = 0.05,
    s_amplitude: float = 0.45,
    seed: int = 0,
    dtype=np.float64,
) -> tuple[np.ndarray, dict]:
    """Render a synthetic MoS2 monolayer HAADF frame.

    Returns (frame [size, size], truth) where truth contains the generated
    Mo/S site coordinates and vacancy mask for detection-accuracy tests.
    """
    rng = np.random.default_rng(seed)
    theta = np.deg2rad(rotation_deg)

    # Honeycomb: hexagonal Bravais lattice with a 2-site basis.
    a1 = spacing * np.array([np.cos(theta), np.sin(theta)])
    a2 = spacing * np.array(
        [np.cos(theta + np.pi / 3), np.sin(theta + np.pi / 3)]
    )
    basis = (a1 + a2) / 3.0  # S site offset inside the cell

    nmax = int(size / spacing * 1.6) + 4
    i, j = np.mgrid[-nmax:nmax, -nmax:nmax]
    cells = i[..., None] * a1 + j[..., None] * a2  # [N, N, 2] (x, y)
    cells = cells.reshape(-1, 2) + size / 2.0

    def in_frame(p, margin=2 * spacing):
        return (
            (p[:, 0] > -margin)
            & (p[:, 0] < size + margin)
            & (p[:, 1] > -margin)
            & (p[:, 1] < size + margin)
        )

    mo = cells[in_frame(cells)]
    s = cells + basis
    s = s[in_frame(s)]

    # Random thermal displacement + sulfur vacancies
    mo = mo + rng.normal(0, 0.03 * spacing, mo.shape)
    s = s + rng.normal(0, 0.03 * spacing, s.shape)
    s_vacancy = rng.random(len(s)) < vacancy_rate
    s_present = s[~s_vacancy]
    mo_vacancy = rng.random(len(mo)) < mo_vacancy_rate
    mo_present = mo[~mo_vacancy]

    frame = np.zeros((size, size), dtype=np.float64)
    yy, xx = np.mgrid[:size, :size]

    def splat(points, amplitude, width):
        # render each Gaussian column on a local window (fast at 2048^2)
        r = int(3 * width) + 1
        for px, py in points:
            x0, y0 = int(round(px)), int(round(py))
            xs, xe = max(0, x0 - r), min(size, x0 + r + 1)
            ys, ye = max(0, y0 - r), min(size, y0 + r + 1)
            if xs >= xe or ys >= ye:
                continue
            gx = xx[ys:ye, xs:xe] - px
            gy = yy[ys:ye, xs:xe] - py
            frame[ys:ye, xs:xe] += amplitude * np.exp(
                -(gx * gx + gy * gy) / (2 * width * width)
            )

    splat(mo_present, 1.0, spacing * 0.18)  # Mo columns: bright (Z-contrast)
    splat(s_present, s_amplitude, spacing * 0.15)  # S2 columns: dimmer

    # slow illumination background + noise, scaled to uint16-like range
    bg = 0.15 * np.sin(2 * np.pi * yy / size) * np.cos(2 * np.pi * xx / size)
    frame = frame + bg + rng.normal(0, noise, frame.shape)
    frame = (frame - frame.min()) / (frame.max() - frame.min())
    frame = (frame * 60000).astype(dtype)

    truth = {
        "mo_sites": mo_present[:, ::-1],  # -> (y, x) convention
        "s_sites": s[:, ::-1],
        "s_vacancies": s[s_vacancy][:, ::-1],
        "mo_vacancies": mo[mo_vacancy][:, ::-1],
        "spacing": spacing,
        "rotation_deg": rotation_deg,
    }
    return frame, truth


def save_frame_h5(path, frame: np.ndarray) -> None:
    """Write a frame using the reference's HDF5 layout.

    Layout Measurement_000/Channel_000/HAADF/HAADF per the reference's
    notebooks (reference notebooks/explore_data_structure.ipynb).
    """
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("Measurement_000/Channel_000/HAADF/HAADF", data=frame)
