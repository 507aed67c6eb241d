"""Synthetic MoS2 HAADF-STEM frames from a seed: the benchmark's input data.

A copy of `livae_tpu_torch/data/synthetic.py`'s `synthetic_mos2_frame`
(honeycomb lattice rotated 7 degrees, bright Mo and dimmer S2 Gaussian
columns, 3 % sulfur vacancies, thermal jitter, a slow illumination background,
noise, scaled to 0-60000), with the columns rendered on the device as one
separable product, Gy^T diag(a) Gx, in float64, untruncated: one matrix
product a frame in place of a Python loop over some 7,000 columns.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed of its own for (seed, *names)."""
    key = "/".join(str(n) for n in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def _columns(rng: np.random.Generator, size: int, spacing: float, vacancy_rate: float,
             rotation_deg: float):
    theta = np.deg2rad(rotation_deg)
    a1 = spacing * np.array([np.cos(theta), np.sin(theta)])
    a2 = spacing * np.array([np.cos(theta + np.pi / 3), np.sin(theta + np.pi / 3)])
    nmax = int(size / spacing * 1.6) + 4
    i, j = np.mgrid[-nmax:nmax, -nmax:nmax]
    cells = (i[..., None] * a1 + j[..., None] * a2).reshape(-1, 2) + size / 2.0

    def inside(p, margin=2 * spacing):
        return ((p[:, 0] > -margin) & (p[:, 0] < size + margin)
                & (p[:, 1] > -margin) & (p[:, 1] < size + margin))

    mo = cells[inside(cells)]
    s = cells + (a1 + a2) / 3.0
    s = s[inside(s)]
    mo = mo + rng.normal(0, 0.03 * spacing, mo.shape)
    s = s + rng.normal(0, 0.03 * spacing, s.shape)
    s = s[~(rng.random(len(s)) < vacancy_rate)]
    return mo, s


def mos2_frame(seed: int, index: int, size: int, spacing: float, device,
               vacancy_rate: float = 0.03, rotation_deg: float = 7.0, noise: float = 0.05,
               s_amplitude: float = 0.45) -> np.ndarray:
    """Frame `index` of run `seed`: [size, size] float64 on the host."""
    rng = np.random.default_rng(stream_seed(seed, "frame", index))
    mo, s = _columns(rng, size, spacing, vacancy_rate, rotation_deg)
    xy = torch.as_tensor(np.concatenate([mo, s]), dtype=torch.float64, device=device)
    width = torch.cat([torch.full((len(mo),), spacing * 0.18), torch.full((len(s),), spacing * 0.15)])
    amp = torch.cat([torch.ones(len(mo)), torch.full((len(s),), s_amplitude)])
    width, amp = width.to(device, torch.float64), amp.to(device, torch.float64)
    grid = torch.arange(size, dtype=torch.float64, device=device)
    gx = torch.exp(-((grid[None, :] - xy[:, 0:1]) ** 2) / (2 * width[:, None] ** 2))
    gy = torch.exp(-((grid[None, :] - xy[:, 1:2]) ** 2) / (2 * width[:, None] ** 2))
    frame = (gy * amp[:, None]).T @ gx  # [y, x]
    frame += 0.15 * torch.outer(torch.sin(2 * np.pi * grid / size), torch.cos(2 * np.pi * grid / size))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "noise", index))
    frame += noise * torch.randn((size, size), generator=gen, dtype=torch.float64, device=device)
    frame = (frame - frame.min()) / (frame.max() - frame.min())
    return (frame * 60000).cpu().numpy()


def mos2_frames(seed: int, count: int, size: int, spacing: float, device) -> list[np.ndarray]:
    return [mos2_frame(seed, i, size, spacing, device) for i in range(count)]
