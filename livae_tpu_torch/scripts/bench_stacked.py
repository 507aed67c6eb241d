#!/usr/bin/env python
"""Stacked trials against sequential trials: train throughput on one GPU (port
of scripts/bench_stacked.py).

Run as  python -m livae_tpu_torch.scripts.bench_stacked [--trials 8 --epochs 3]

K configs of one architecture (lr from 1e-4 to 3e-3 and beta from 0.5 to 8,
both geometric; weight decay 1e-5, gamma 0), E epochs each, on one synthetic
frame: (a) one after another, each trial its own model, AdamW and fused VAE
train step (the sweep's trial), and (b) as one K-lane stacked step
(livae_tpu_torch.sweep.stacked). Each path warms up on an epoch of its own
first; every lane is initialised outside the timed region; each timed region
ends in a synchronisation of the device. Prints one JSON line with the JAX
script's keys ("backend" is "cuda" or "cpu"), plus the card (name and power
limit), each path's peak memory and the stacked epoch's kernel launches.

`--cpu --quick` runs the plain versions on the CPU in seconds (patch 32,
batch 64, 2 trials, 2 epochs, one 512-pixel frame).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..data.datasets import AdaptiveLatticeDataset, default_transform
from ..data.synthetic import synthetic_mos2_frame
from ..device import resolve_device
from ..models.rvae import RVAE
from ..sweep import make_stacked_fns, set_stacked_hyperparams
from ..sweep.stacked import StackedState
from ..train.engine import make_fused_vae_train_step
from ..train.state import make_optimizer
from ._common import (
    card_description,
    epoch_index_batches,
    kernel_launches,
    prebuild_kernels,
    split_indices,
    stream_generator,
    sync,
)

__all__ = ["build_argparser", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--patch-size", type=int, default=128)
    p.add_argument("--padding", type=int, default=32)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes for a smoke run (patch 32, batch 64, 2 trials)")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.quick:
        args.patch_size, args.padding = 32, 8
        args.batch_size, args.synthetic_size = 64, 512
        args.trials, args.epochs, args.latent_dim = 2, 2, 8
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device, file=sys.stderr)
    frame = synthetic_mos2_frame(size=args.synthetic_size, spacing=40.0, seed=0)[0]
    dataset = AdaptiveLatticeDataset([frame], patch_size=args.patch_size, padding=args.padding,
                                     transform=default_transform, device=device)
    train_idx, _ = split_indices(len(dataset), 0.1, seed=0)
    bs = min(args.batch_size, len(train_idx))
    steps = max(1, len(train_idx) // bs)
    train_idx = torch.as_tensor(train_idx, dtype=torch.long, device=device)
    site_table = dataset.device_site_table[:3]
    compute_dtype = "bfloat16" if device.type == "cuda" else None
    mk = dict(patch_size=args.patch_size, padding=args.padding, cfg=dataset.transform,
              margin=dataset._margin, grad_max_norm=20.0, device=device)

    K = args.trials
    lrs = np.geomspace(1e-4, 3e-3, K)
    betas = np.geomspace(0.5, 8.0, K)

    def model(seed):
        return RVAE(args.latent_dim, 1, args.patch_size, compute_dtype, device=device,
                    generator=stream_generator(seed, "init", 0, "cpu"))

    def trial(seed, lr):
        m = model(seed)
        step = make_fused_vae_train_step(
            m, make_optimizer(m, float(lr), optimizer="adamw", weight_decay=1e-5), **mk)
        return step

    def epoch_idx(gen):
        return epoch_index_batches(train_idx, bs, gen)[:steps]

    def peak_reset():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    def peak_gib():
        return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0

    n_patches = K * args.epochs * steps * bs

    # --- sequential ---------------------------------------------------
    warm = stream_generator(999, "train", 0, device)
    trial(999, 1e-3)(*site_table, epoch_idx(warm), warm, 1.0, 0.0)
    sync(device)
    # per-trial init outside the timed region (the stacked path inits its
    # lanes before its timed region too: measure training, not init)
    seq_lanes = [trial(i, lrs[i]) for i in range(K)]
    peak_reset()
    t0 = time.perf_counter()
    for i, step in enumerate(seq_lanes):
        for e in range(args.epochs):
            gen = stream_generator(i, "train", e, device)
            step(*site_table, epoch_idx(gen), gen, float(betas[i]), 0.0)
    sync(device)
    seq_s = time.perf_counter() - t0
    seq_peak = peak_gib()
    del seq_lanes

    # --- stacked -------------------------------------------------------
    models = [model(i) for i in range(K)]
    stacked_step, _ = make_stacked_fns(models[0], **mk)
    state = set_stacked_hyperparams(StackedState.create(models), lrs, [1e-5] * K)
    del models
    gammas = [0.0] * K
    warm = [stream_generator(100 + i, "train", 0, device) for i in range(K)]
    stacked_step(state, *site_table, torch.stack([epoch_idx(g) for g in warm]), warm,
                 betas, gammas)
    sync(device)
    peak_reset()
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    for e in range(args.epochs):
        gens = [stream_generator(i, "train", e, device) for i in range(K)]
        stacked_step(state, *site_table, torch.stack([epoch_idx(g) for g in gens]), gens,
                     betas, gammas)
    sync(device)
    stk_s = time.perf_counter() - t0
    launches = {k: (v - launches0[k]) // args.epochs for k, v in kernel_launches().items()}

    result = {
        "trials": K,
        "epochs": args.epochs,
        "patch_size": args.patch_size,
        "batch_size": bs,
        "steps_per_epoch": steps,
        "sequential_s": round(seq_s, 3),
        "stacked_s": round(stk_s, 3),
        "speedup": round(seq_s / stk_s, 3),
        "seq_patches_per_sec": round(n_patches / seq_s, 1),
        "stacked_patches_per_sec": round(n_patches / stk_s, 1),
        "backend": device.type,
        "card": card_description(device),
        "seq_max_memory_gib": seq_peak,
        "stacked_max_memory_gib": peak_gib(),
        "stacked_launches_per_epoch": launches,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
