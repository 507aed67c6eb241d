#!/usr/bin/env python
"""Pretrain only the RotationSTN with cycle consistency, on one GPU.

Run as  python -m livae_tpu_torch.scripts.pretrain_stn --synthetic 2 ...

The flags, defaults and checkpoint of scripts/pretrain_stn.py (the JAX
script): paired data (`PairedAdaptiveLatticeDataset`, `default_transform`),
loss = cycle_consistency_loss(theta, theta_rot, angle) on the localisation
net alone, AdamW (lr 1e-3, weight decay 1e-5) over the STN's parameters only,
global-norm clip at 5.0, 30 epochs, batch 512, padding 32, and the best val
epoch saved as {"rotation_stn": state, "epoch", "best_val", "args"} with the
state in `stn_spec`'s keys. `train_rvae --stn-checkpoint` loads it.

The model is float32. Batches are taken in the split's order, the train
batches without their ragged tail, the val batches with it; each epoch draws
its augmentation from a generator of (seed, "train" or "val", epoch). Runs on
the CUDA device unless --cpu is given; --num-workers and --prefetch-factor are
accepted and ignored.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..data.datasets import PairedAdaptiveLatticeDataset, default_transform
from ..device import resolve_device
from ..losses import cycle_consistency_loss
from ..models.rvae import RVAE
from ..train.engine import _clip_by_global_norm
from ..train.state import make_optimizer
from ..utils.checkpoint import save_checkpoint
from ._common import (
    add_data_flags,
    batched,
    kernel_launches,
    prebuild_kernels,
    resolve_images,
    split_indices,
    stream_generator,
)

__all__ = ["make_stn_optimizer", "make_stn_pretrain_step", "run_pretrain", "build_argparser"]


def make_stn_optimizer(model: RVAE, lr: float, weight_decay: float) -> torch.optim.Optimizer:
    """AdamW over the STN's parameters only: every other parameter keeps its
    bits, as under the JAX script's set_to_zero."""
    return make_optimizer(model.encoder.rotation_stn.parameters(), lr, optimizer="adamw",
                          weight_decay=weight_decay)


def _cycle_loss(model, x, x_rot, angle) -> torch.Tensor:
    """The cycle loss of the localisation net's two angles, as one [2B] pass
    (the same math as two passes: no layer couples the samples)."""
    theta = model.predict_theta(torch.cat([x, x_rot.to(x.dtype)]))
    B = x.shape[0]
    return cycle_consistency_loss(theta[:B], theta[B:], angle)


def make_stn_pretrain_step(model, optimizer, max_norm: float = 5.0):
    """step(x, x_rot, angle) -> (loss, grad norm), 0-d device tensors.

    Only the localisation net gets gradients; the other parameters' are None,
    which the clip counts as the zeros the JAX step sees, so the global norm
    is the STN's."""

    def step(x, x_rot, angle):
        for p in model.parameters():
            p.grad = None
        loss = _cycle_loss(model, x, x_rot, angle)
        loss.backward()
        gnorm = _clip_by_global_norm([p.grad for p in model.parameters() if p.grad is not None],
                                     max_norm)
        optimizer.step()
        return loss.detach(), gnorm

    return step


def run_pretrain(args) -> dict:
    device = resolve_device("cpu" if args.cpu else None)
    kernel_build_s = prebuild_kernels(device)
    images = resolve_images(args)
    dataset = PairedAdaptiveLatticeDataset(
        images, patch_size=args.patch_size, padding=args.padding,
        transform=default_transform, device=device,
    )
    train_idx, val_idx = split_indices(len(dataset), args.val_split, seed=args.seed)
    print(f"Dataset: {len(dataset)} sites ({len(train_idx)} train / {len(val_idx)} val)")

    model = RVAE(latent_dim=args.latent_dim, patch_size=args.patch_size, device=device,
                 generator=stream_generator(args.seed, "init", 0, "cpu"))
    optimizer = make_stn_optimizer(model, args.lr, args.weight_decay)
    train_step = make_stn_pretrain_step(model, optimizer, 5.0)
    stn = model.encoder.rotation_stn

    best_val = float("inf")
    epochs: list[dict] = []
    t_start = time.time()
    for epoch in range(args.epochs):
        train_gen = stream_generator(args.seed, "train", epoch, device)
        val_gen = stream_generator(args.seed, "val", epoch, device)
        launches0 = kernel_launches()
        t0 = time.time()
        train_losses = []
        for chunk in batched(train_idx, args.batch_size):
            x, x_rot, angle = dataset.batch_at(chunk, train_gen)
            train_losses.append(train_step(x, x_rot, angle)[0])
        train_loss = float(torch.stack(train_losses).mean()) if train_losses else float("nan")
        train_s = time.time() - t0
        val_losses = []
        with torch.no_grad():
            for chunk in batched(val_idx, min(args.batch_size, len(val_idx)), drop_last=False):
                x, x_rot, angle = dataset.batch_at(chunk, val_gen)
                val_losses.append(_cycle_loss(model, x, x_rot, angle))
        val_loss = float(torch.stack(val_losses).mean())
        launches1 = kernel_launches()
        epochs.append({
            "epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
            "steps": len(train_losses), "val_batches": len(val_losses), "train_s": train_s,
            "eval_s": time.time() - t0 - train_s,
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
        })
        print(f"Epoch {epoch + 1}/{args.epochs} | cycle train {train_loss:.4f} | "
              f"val {val_loss:.4f}")

        if val_loss < best_val:
            best_val = val_loss
            save_checkpoint(
                args.checkpoint,
                {"rotation_stn": stn.state_dict(), "epoch": epoch, "best_val": best_val,
                 "args": vars(args)},
            )
            print(f"  -> saved STN checkpoint ({args.checkpoint})")

    print(f"Done in {time.time() - t_start:.0f}s | best val cycle loss {best_val:.4f}")
    return {"best_val": best_val, "model": model, "optimizer": optimizer, "epochs": epochs,
            "kernel_build_s": kernel_build_s,
            "sites": (len(dataset), len(train_idx), len(val_idx))}


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Pretrain RotationSTN with cycle consistency (GPU)")
    add_data_flags(parser)
    parser.add_argument("--patch-size", type=int, default=128)
    parser.add_argument("--padding", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--val-split", type=float, default=0.1)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--latent-dim", type=int, default=16)
    parser.add_argument("--log-dir", type=str, default="runs/stn")
    parser.add_argument("--checkpoint", type=str, default="checkpoints/stn_pretrained.pt")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-workers", type=int, default=8, help=argparse.SUPPRESS)
    parser.add_argument("--prefetch-factor", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    return parser


if __name__ == "__main__":
    run_pretrain(build_argparser().parse_args())
