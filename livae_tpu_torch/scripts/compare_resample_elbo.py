#!/usr/bin/env python
"""The ELBO gate of the fast resampler: the full rVAE objective with the fast
3-shear rotation and with the exact bilinear one (port of
scripts/compare_resample_elbo.py).

Run as  python -m livae_tpu_torch.scripts.compare_resample_elbo --synthetic 1 --train-epochs 5
        python -m livae_tpu_torch.scripts.compare_resample_elbo --checkpoint checkpoints/rvae_best.pt

The complete objective (recon + beta KL + gamma cycle + 0.2 x the canonical
term) of `RVAE(fast_resample=True)` and `RVAE(fast_resample=False)` on the same
weights, the same val batches and the same reparameterisation noise; prints
their relative difference against the ELBO gate of BASELINE.json ("ELBO
within 1% of baseline"). The weights come from --checkpoint or from a short
fused paired training of the fast model (--train-epochs); --dual-train also
trains both models from one init and compares their final train losses.
`--compute-dtype bfloat16` runs the fast model in the production precision.
The JAX script's flags and JSON keys. Runs on the CUDA device unless --cpu is
given; `main` returns the result.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import PairedAdaptiveLatticeDataset, default_transform
from ..device import resolve_device
from ..models.rvae import RVAE
from ..train.engine import make_fused_rvae_train_step, make_rvae_eval_step, metrics_to_host
from ..train.state import make_optimizer
from ..utils.checkpoint import load_reference_checkpoint
from ._common import (
    add_data_flags,
    epoch_index_batches,
    prebuild_kernels,
    resolve_images,
    split_indices,
    stream_generator,
)

__all__ = ["elbo_gate", "full_objective", "short_train", "main", "build_argparser"]

BASELINE = Path(__file__).resolve().parents[2] / "BASELINE.json"


def elbo_gate() -> float:
    """The ELBO tolerance BASELINE.json states ("ELBO within N% of baseline"),
    as a fraction."""
    text = json.loads(BASELINE.read_text())["north_star"]
    found = re.search(r"ELBO within (\d+(?:\.\d+)?)% of baseline", text)
    if found is None:
        raise ValueError(f"{BASELINE} states no ELBO tolerance")
    return float(found.group(1)) / 100


def full_objective(model, batches, beta, gamma, canonical_weight, eps) -> float:
    """Mean full rVAE objective over fixed batches, batch i with noise eps[i]."""
    eval_step = make_rvae_eval_step(model, canonical_weight=canonical_weight,
                                    device=next(model.parameters()).device)
    losses = [float(eval_step(x, x_rot, angle, beta, gamma, eps=e)["loss"])
              for (x, x_rot, angle), e in zip(batches, eps)]
    return float(np.mean(losses))


def short_train(model, dataset, train_idx, epochs, batch_size, beta, gamma, seed) -> float:
    """Train `model` in place for `epochs` fused paired epochs (AdamW 1e-3,
    weight decay 1e-5, canonical weight 0.2, clip 20); returns the last
    epoch's train loss."""
    device = dataset.device
    step = make_fused_rvae_train_step(
        model, make_optimizer(model, 1e-3, optimizer="adamw", weight_decay=1e-5),
        patch_size=dataset.patch_size, padding=dataset.padding, cfg=dataset.transform,
        margin=dataset._margin, canonical_weight=0.2, grad_max_norm=20.0, device=device,
    )
    train_idx = torch.as_tensor(train_idx, dtype=torch.long, device=device)
    m = {"loss": float("nan")}
    for epoch in range(epochs):
        gen = stream_generator(seed, "train", epoch, device)
        idx_batches = epoch_index_batches(train_idx, batch_size, gen)
        m = metrics_to_host(step(*dataset.device_site_table[:3], idx_batches, gen, beta, gamma))
    return float(m["loss"])


def main(args) -> dict:
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device)
    images = resolve_images(args)
    dataset = PairedAdaptiveLatticeDataset(images, patch_size=args.patch_size,
                                           padding=args.padding, transform=default_transform,
                                           device=device)
    train_idx, val_idx = split_indices(len(dataset), 0.1, seed=args.seed)
    batch_size = min(args.batch_size, len(val_idx), len(train_idx))
    print(f"Dataset: {len(dataset)} sites; eval batch {batch_size}")

    # --compute-dtype bfloat16 measures the production numerics (bf16 convs and
    # rotations) against the f32 exact path; "none" keeps the resampler A/B pure
    cd = args.compute_dtype if args.compute_dtype != "none" else None
    latent, patch = args.latent_dim, args.patch_size
    state = None
    if args.checkpoint:
        state, payload = load_reference_checkpoint(args.checkpoint)
        ck_args = payload.get("args") or {}
        latent = int(ck_args.get("latent_dim", latent))
        patch = int(ck_args.get("patch_size", patch))

    def model(fast: bool, seed: int) -> RVAE:
        return RVAE(latent, 1, patch, cd if fast else None, fast_resample=fast, device=device,
                    generator=stream_generator(seed, "init", 0, "cpu"))

    fast_model, exact_model = model(True, args.seed), model(False, args.seed)
    if state is not None:
        print(f"Loaded weights from {args.checkpoint}")
    else:
        print(f"Training {args.train_epochs} fast-path epochs for realistic weights...")
        last = short_train(fast_model, dataset, train_idx, args.train_epochs, batch_size,
                           args.beta, args.gamma, args.seed)
        print(f"  final fast-path train loss {last:.4f}")
        state = fast_model.state_dict()
    fast_model.load_state_dict(state, strict=True)
    exact_model.load_state_dict(state, strict=True)

    # identical batches and sampling noise through both resamplers
    n_batches = max(1, min(args.eval_batches, len(val_idx) // batch_size))
    batches = [dataset.batch_at(val_idx[i * batch_size:(i + 1) * batch_size],
                                stream_generator(args.seed + 7, "eval", 1000 + i, device))
               for i in range(n_batches)]
    eps = [torch.randn((len(b[0]), latent), device=device,
                       generator=stream_generator(args.seed + 7, "eps", i, device))
           for i, b in enumerate(batches)]
    fast = full_objective(fast_model, batches, args.beta, args.gamma, 0.2, eps)
    exact = full_objective(exact_model, batches, args.beta, args.gamma, 0.2, eps)
    rel = abs(fast - exact) / abs(exact)
    gate = elbo_gate()
    result = {
        "fast_objective": fast,
        "exact_objective": exact,
        "relative_delta": rel,
        "gate": gate,
        "passes_1pct_gate": bool(rel < gate),
        "batches": n_batches,
        "batch_size": batch_size,
        "beta": args.beta,
        "gamma": args.gamma,
    }

    if args.dual_train:
        print("Dual-path short training (same seeds, fast vs exact)...")
        fast_final = short_train(model(True, args.seed + 100), dataset, train_idx,
                                 args.train_epochs, batch_size, args.beta, args.gamma,
                                 args.seed + 100)
        exact_final = short_train(model(False, args.seed + 100), dataset, train_idx,
                                  args.train_epochs, batch_size, args.beta, args.gamma,
                                  args.seed + 100)
        result["dual_train"] = {
            "fast_final_loss": fast_final,
            "exact_final_loss": exact_final,
            "relative_delta": abs(fast_final - exact_final) / abs(exact_final),
        }

    print(json.dumps(result, indent=2))
    return result


def build_argparser():
    p = argparse.ArgumentParser(description="Fast-vs-exact resampler ELBO gate")
    add_data_flags(p)
    p.add_argument("--patch-size", type=int, default=128)
    p.add_argument("--padding", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--compute-dtype", type=str, default="none",
                   choices=["none", "bfloat16"],
                   help="fast-path compute dtype; bfloat16 = production AMP analog")
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--beta", type=float, default=10.0)
    p.add_argument("--gamma", type=float, default=10.0)
    p.add_argument("--train-epochs", type=int, default=5)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dual-train", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    return p


if __name__ == "__main__":
    main(build_argparser().parse_args())
