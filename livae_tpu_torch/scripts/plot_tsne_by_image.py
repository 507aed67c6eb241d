#!/usr/bin/env python
"""Standalone t-SNE-by-image plot for a trained rVAE.

Run as  python -m livae_tpu_torch.scripts.plot_tsne_by_image --checkpoint ... --synthetic 2

The flags, defaults and artifact of scripts/plot_tsne_by_image.py (the JAX
script): the checkpoint is read as an rVAE, every site encoded
(`visualizations.collect_stats`), the latent means embedded with t-SNE (PCA
fallback) and plotted by source image into runs/plots/embedding_by_image3.png.
Runs on the CUDA device unless --cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ._common import add_data_flags
from .visualizations import _pyplot, collect_stats, embed_latents, load_for_analysis


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="t-SNE latent embedding by image (rVAE)")
    add_data_flags(parser)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/rvae_best.pt")
    parser.add_argument("--padding", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--out", type=str, default="runs/plots/embedding_by_image3.png")
    parser.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    model, _, dataset = load_for_analysis(args, "rvae")
    mu, _, _, idx_map = collect_stats(model, dataset, args.batch_size, is_rvae=True)
    image_sources = np.array([i for i, _ in idx_map])

    emb = embed_latents(mu)

    plt = _pyplot()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    plt.figure(figsize=(7, 7))
    cmap = plt.get_cmap("tab10")
    for i, img_idx in enumerate(np.unique(image_sources)):
        mask = image_sources == img_idx
        plt.scatter(emb[mask, 0], emb[mask, 1], s=8, color=cmap(i % 10),
                    label=f"Image {img_idx}", alpha=0.8)
    plt.legend(markerscale=2)
    plt.title("rVAE latent embedding by source image")
    plt.tight_layout()
    plt.savefig(out, dpi=150)
    plt.close()
    print(f"Saved {out}")


if __name__ == "__main__":
    main()
