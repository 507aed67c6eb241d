#!/usr/bin/env python
"""Retrain the rVAE with the best config of a hyperparameter search (port of
scripts/train_rvae_with_best.py).

Run as  python -m livae_tpu_torch.scripts.train_rvae_with_best
            [--config checkpoints/best_config.json] [--override-epochs N] [train_rvae flags]

Reads best_config.json (train_rvae_raytune's --save-best-config), sets lr,
beta, weight_decay, gamma, latent_dim, batch_size and normalize on the
train_rvae arguments (every other flag passes through to train_rvae), takes
the config's epochs unless --override-epochs is given, and calls
train_rvae.run_training. The file is read, never written.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from . import train_rvae


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train rVAE with best hyperparameters from a sweep"
    )
    parser.add_argument(
        "--config", type=str, default="checkpoints/best_config.json",
        help="Path to best_config.json from train_rvae_raytune",
    )
    parser.add_argument("--override-epochs", type=int, default=None)
    known, passthrough = parser.parse_known_args(argv)
    passthrough = [a for a in passthrough if a != "--"]

    config_path = Path(known.config)
    if not config_path.exists():
        raise SystemExit(
            f"Best config not found: {config_path}. Run train_rvae_raytune first."
        )
    best = json.loads(config_path.read_text())
    print(f"Loaded best config from {config_path}:")
    for k in ("lr", "latent_dim", "beta", "weight_decay", "batch_size"):
        if k in best:
            print(f"  {k}: {best[k]}")

    args = train_rvae.build_argparser().parse_args(passthrough)
    # gamma is searched by the native sweep (not by the reference's): a superset
    for k in ("lr", "beta", "weight_decay", "gamma"):
        if k in best:
            setattr(args, k, float(best[k]))
    for k in ("latent_dim", "batch_size"):
        if k in best:
            setattr(args, k, int(best[k]))
    if "normalize" in best:
        # sweep trials carry per-patch norm as `normalize`; train_rvae as
        # --no-per-patch-norm (persisted in the checkpoint's args)
        args.no_per_patch_norm = not bool(best["normalize"])
        if args.no_per_patch_norm:
            print("  per-patch norm: off (from best config)")
    if known.override_epochs is not None:
        args.epochs = known.override_epochs
    elif "epochs" in best:
        args.epochs = int(best["epochs"])

    return train_rvae.run_training(args)


if __name__ == "__main__":
    main()
