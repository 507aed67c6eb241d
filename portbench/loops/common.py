"""What the loops share: the run's seed streams, weights made on the device,
the site-table build, the program's kernel build, and the augmentation
draws the training entry points take."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import frames as F
from ..frames import stream_seed

__all__ = ["stream_seed", "generator", "make_weights", "build_frames", "prebuild", "split",
           "sync", "StepTimer", "percentile", "gap", "init_device", "augment_draws"]


def generator(seed: int, *names, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *names))


def make_weights(model: torch.nn.Module, seed: int, init: dict, device) -> dict:
    """Weights for the model's state-dict keys, drawn on the device from the
    seed in one call: U(+-1 / sqrt(fan_in)) for every weight and bias (fan_in
    from the weight's second axis on, PyTorch's default), U(+-std sqrt 3) for
    the keys in init["std"], zeros for those in init["zeros"]."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(seed, "weights", device=device), device=device)
    u = 2.0 * u - 1.0
    out, off = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        w = shapes[k.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / math.sqrt(math.prod(w[1:]))
        if k in init.get("std", {}):
            bound = init["std"][k] * math.sqrt(3.0)
        if k in init.get("zeros", []):
            bound = 0.0
        out[k] = (u[off:off + n] * bound).reshape(shape)
        off += n
    return out


def build_frames(seed: int, traffic: dict, device) -> list[np.ndarray]:
    return F.mos2_frames(seed, traffic["frames"], traffic["frame_size"], traffic["spacing"], device)


def init_device(device) -> None:
    """Create the CUDA context now, so that its cost shows in a span of its own."""
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)


def prebuild(device) -> None:
    """The program's kernel build, as its entry points run it first."""
    from livae_tpu_torch.scripts._common import prebuild_kernels

    prebuild_kernels(device, file=sys.stderr)


def augment_draws(cfg: dict, B: int, generator: torch.Generator, device):
    """One step's augmentation draws (the program's PairedDraws: scale,
    flips, jitter and the pair's angle) and its [B, latent] noise, from
    `generator` on the device."""
    from livae_tpu_torch.data.pipeline import PairedDraws

    a, kw = cfg["augment"], dict(generator=generator, device=device)
    scale = a["scale_min"] + (a["scale_max"] - a["scale_min"]) * torch.rand(B, **kw)
    flip_h = torch.rand(B, **kw) < a["flip_prob"]
    flip_v = torch.rand(B, **kw) < a["flip_prob"]
    jy = torch.randint(-a["jitter"], a["jitter"] + 1, (B,), **kw)
    jx = torch.randint(-a["jitter"], a["jitter"] + 1, (B,), **kw)
    angle = 2 * math.pi * torch.rand(B, **kw)
    eps = torch.randn((B, cfg["latent_dim"]), dtype=torch.float32, **kw)
    return PairedDraws(scale, flip_h, flip_v, jy, jx, angle), eps


def split(n: int, val_split: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) site indices: a permutation from the seed, the first
    max(1, n x val_split) for validation."""
    perm = np.random.default_rng(stream_seed(seed, "split")).permutation(n)
    n_val = max(1, int(n * val_split))
    return perm[n_val:], perm[:n_val]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Each step's time: CUDA events around the call on the card (the
    interval on the device's timeline), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def __call__(self, fn):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = fn()
            ev[1].record()
            self.marks.append(ev)
        else:
            t = time.perf_counter()
            out = fn()
            self.marks.append((t, time.perf_counter()))
        return out

    def ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)
