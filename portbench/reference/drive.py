"""The reference's runs: a training step followed from given weights, and the
analysis pass over every site. Inputs (frames, sites, augmentation draws,
noise, weights) come from the benchmark; what the program derived from them
is worked out again here.
"""

from __future__ import annotations

import contextlib

import torch

from . import common as C
from . import rvae, vae


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and matrix products with TF32 off, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def follow_training(model: str, params0: dict, frames: torch.Tensor, steps: list[dict],
                    cfg: dict, lrs: list[float], precision: dict, half: bool = False) -> dict:
    """Train a copy of params0 through `steps` (each: img_idx, coords, draws,
    eps) with clip and Adam(W) at the rates `lrs`, at `precision` ({"conv",
    "io"}, see rvae.py). Returns the losses, the first step's loss terms, each
    leaf's first (clipped) gradient and its norm, and each leaf's change after
    the last step. `half` keeps the first half of every batch (a planted fault)."""
    params = {k: v.detach().float().clone().requires_grad_() for k, v in params0.items()}
    opt, lc = cfg["optimizer"], cfg["loss"]
    state: dict = {}
    losses, first, terms = [], None, {}
    with full_float32():
        for t, s in enumerate(steps, 1):
            n = s["img_idx"].shape[0] // (2 if half else 1)
            draws = {k: v[:n] for k, v in s["draws"].items()}
            with torch.no_grad():
                out = C.extract(frames, s["img_idx"][:n], s["coords"][:n], cfg["patch_size"],
                                cfg["padding"], draws, cfg["normalize"], paired=model == "rvae",
                                io_precision=precision["io"])
            if model == "rvae":
                x, x_rot, angle = out
                loss, parts = rvae.paired_loss(params, x, x_rot, angle, s["eps"][:n], precision, lc)
            elif model == "vae":
                loss, parts = vae.loss(params, out, s["eps"][:n], precision, lc)
            else:
                raise ValueError(f"no reference for model {model!r}")
            if not terms:
                terms = {k: v.item() for k, v in parts.items()}
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            C.clip_(list(grads.values()), cfg["grad_max_norm"])
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                C.adam_step_(params, grads, state, lrs[t - 1], t, opt["weight_decay"],
                             tuple(opt["betas"]), opt["eps"])
            losses.append(loss.item())
    change = {k: (params[k].detach() - params0[k].float()).norm().item() for k in params}
    return {"losses": losses, "terms": terms, "grads": first,
            "grad_norms": {k: g.norm().item() for k, g in first.items()}, "change_norms": change}


@torch.no_grad()
def encode_all(params: dict, frames: torch.Tensor, img_idx: torch.Tensor, coords: torch.Tensor,
               cfg: dict, padding: int, batch: int, precision: dict, latent: int) -> dict:
    """The analysis pass: batches of `batch` in site order, the tail as one
    smaller batch, each with the noise of a generator seeded 0. Returns mu,
    logvar, rec_err, theta and the angle's condition number of every site."""
    out = {"mu": [], "logvar": [], "rec_err": [], "theta": [], "cond": []}
    with full_float32():
        for i in range(0, img_idx.shape[0], batch):
            sl = slice(i, i + batch)
            x = C.extract(frames, img_idx[sl], coords[sl], cfg["patch_size"], padding, None,
                          cfg["normalize"])
            gen = torch.Generator(device=x.device).manual_seed(0)
            eps = torch.randn((x.shape[0], latent), generator=gen, dtype=torch.float32,
                              device=x.device)
            for k, v in zip(out, rvae.batch_stats(params, x, eps, precision)):
                out[k].append(v)
    return {k: torch.cat(v) for k, v in out.items()}
