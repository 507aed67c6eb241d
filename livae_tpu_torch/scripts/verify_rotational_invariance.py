#!/usr/bin/env python
"""Verify that a trained rVAE's latent code is rotation-invariant.

Run as  python -m livae_tpu_torch.scripts.verify_rotational_invariance --checkpoint ... --synthetic 2

The flags and defaults of scripts/verify_rotational_invariance.py (the JAX
script): encode probes of the frames and their 90-degree rotations, compare
the latent means by Euclidean distance and cosine similarity, with the
verdicts HIGHLY (cosine > 0.99), LARGELY (> 0.95) or NOT rotation-invariant.
Checks one checkpoint, or with --sweep-dir the --top-k trials of a sweep's
results.json by val_loss. Runs on the CUDA device unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..ops.resample import rotate_image_fast
from ._common import add_data_flags, resolve_images
from .visualizations import load_for_analysis

__all__ = ["check_invariance", "sweep_checkpoints", "main"]


@torch.no_grad()
def check_invariance(model, patch: torch.Tensor) -> dict:
    """Latent distance and cosine between probes [B, 1, S, S] and their rot90
    copies."""
    rotated = rotate_image_fast(patch, torch.full((patch.shape[0],), math.pi / 2,
                                                  device=patch.device))
    mu1 = model.encode(patch)[0].cpu().numpy()
    mu2 = model.encode(rotated)[0].cpu().numpy()
    dist = float(np.linalg.norm(mu1 - mu2, axis=1).mean())
    cos = float(
        np.mean(
            np.sum(mu1 * mu2, axis=1)
            / np.maximum(np.linalg.norm(mu1, axis=1) * np.linalg.norm(mu2, axis=1), 1e-12)
        )
    )
    if cos > 0.99:
        verdict = "HIGHLY rotation-invariant"
    elif cos > 0.95:
        verdict = "LARGELY rotation-invariant"
    else:
        verdict = "NOT rotation-invariant"
    return {"euclidean_distance": dist, "cosine_similarity": cos, "verdict": verdict}


def sweep_checkpoints(sweep_dir: str, top_k: int) -> list[str]:
    """The checkpoints of the top_k trials of <sweep_dir>/results.json, best
    val_loss first; trials without a checkpoint are left out."""
    results_file = Path(sweep_dir) / "results.json"
    if not results_file.exists():
        raise SystemExit(f"No results.json in {sweep_dir}")
    trials = json.loads(results_file.read_text())
    trials = sorted(
        (t for t in trials if t.get("checkpoint")),
        key=lambda t: t.get("val_loss", float("inf")),
    )[:top_k]
    return [t["checkpoint"] for t in trials]


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Verify rVAE rotational invariance")
    add_data_flags(parser)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/rvae_best.pt")
    parser.add_argument(
        "--sweep-dir", type=str, default=None,
        help="Sweep results directory: verify the top-k trials instead",
    )
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--padding", type=int, default=16)
    parser.add_argument("--n-patches", type=int, default=32)
    parser.add_argument("--cpu", action="store_true")
    return parser


def main(argv=None) -> list[dict]:
    args = build_argparser().parse_args(argv)
    if args.sweep_dir:
        checkpoints = sweep_checkpoints(args.sweep_dir, args.top_k)
        print(f"Verifying top {len(checkpoints)} sweep trials")
    else:
        checkpoints = [args.checkpoint]

    images = resolve_images(args)
    results = []
    for ckpt_path in checkpoints:
        args.checkpoint = ckpt_path
        model, _, dataset = load_for_analysis(args, "rvae", images)
        idx = np.linspace(0, len(dataset) - 1, args.n_patches).astype(int)
        result = check_invariance(model, dataset.batch_at(idx))
        print(
            f"{ckpt_path}: cos={result['cosine_similarity']:.4f} "
            f"dist={result['euclidean_distance']:.4f} -> {result['verdict']}"
        )
        results.append({"checkpoint": ckpt_path, **result})
    return results


if __name__ == "__main__":
    main()
