#!/usr/bin/env python
"""Latent-space analysis: batched encode -> t-SNE/PCA -> cluster maps.

Run as  python -m livae_tpu_torch.scripts.visualizations --checkpoint ... --synthetic 2

The flags, defaults and artifacts are those of scripts/visualizations.py (the
JAX script): it loads a trained VAE or rVAE checkpoint (the geometry read back
from the saved `args`; the type detected from the `rotation_stn` keys, which
--rvae / --vae override), encodes every site of an un-augmented
`AdaptiveLatticeDataset` in batches, embeds the latent means with t-SNE (PCA
fallback) and writes

    plots/latent_embeddings.png            (coloured by source image)
    plots/clusters/image_N_clusters.png    (KMeans patch cluster maps)
    plots/windows/latent_hist_scatter_wsN.png
    plots/atom_clusters/image_N_atom_clusters.png

Coordinates are (y, x). The encode runs on the CUDA device (--cpu: the plain
PyTorch versions on the CPU), in float32. sklearn and matplotlib are imported
by the steps that need them.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import AdaptiveLatticeDataset
from ..device import resolve_device
from ..models.rvae import RVAE
from ..models.vae import VAE
from ..tracing import span
from ..utils.checkpoint import load_reference_checkpoint
from ._common import add_data_flags, batched, prebuild_kernels, resolve_images

__all__ = [
    "load_model_from_checkpoint",
    "checkpoint_normalize",
    "collect_stats",
    "embed_latents",
    "plot_latents",
    "plot_clusters_on_images",
    "plot_windows",
    "plot_atom_clusters",
    "main",
]


def load_model_from_checkpoint(ckpt_path: str, force_type: str | None = None, device=None):
    """Rebuild the model of a reference-format checkpoint on `device` (CUDA
    unless "cpu"), weights loaded strictly, in eval mode.

    Returns (model, is_rvae, latent_dim, patch_size, payload); the JAX script
    returns the params beside the model, which here holds its weights."""
    device = resolve_device(device)
    state, payload = load_reference_checkpoint(ckpt_path)
    args = payload.get("args", {})
    latent_dim = args.get("latent_dim", 16)
    patch_size = args.get("patch_size", 128)
    is_rvae = (
        force_type == "rvae" if force_type else any("rotation_stn" in k for k in state.keys())
    )
    make = RVAE if is_rvae else VAE
    # the initial draws are overwritten by the checkpoint; a fixed generator
    # leaves the global RNG alone
    model = make(latent_dim=latent_dim, patch_size=patch_size, device=device,
                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state, strict=True)
    model.eval()
    return model, is_rvae, latent_dim, patch_size, payload


def checkpoint_normalize(payload) -> bool:
    """Per-patch-norm semantics the checkpoint was trained with: a sweep
    trial's `normalize` first, else not the trainers' `no_per_patch_norm`.
    Encoding with another normalisation than training's is a train/eval
    mismatch, so every analysis script builds its dataset through this."""
    args = payload.get("args", {})
    if "normalize" in args:
        return bool(args["normalize"])
    return not args.get("no_per_patch_norm", False)


def _batch_stats(model, x: torch.Tensor, is_rvae: bool, eps=None, generator=None):
    """(mu, logvar, per-patch MSE) of one batch from one forward pass; the
    rVAE's error is taken on its canonical reconstruction (out[1]). The
    forward's mu and logvar are the encoder's, so no second STN pass runs."""
    out = model(x, eps, generator)
    recon = out[1] if is_rvae else out[0]
    mu, logvar = out[-2], out[-1]
    return mu, logvar, torch.mean((recon - x) ** 2, dim=(1, 2, 3))


@torch.no_grad()
def collect_stats(model, dataset, batch_size: int, is_rvae: bool, eps=None):
    """Batched encode of every site: (mu, logvar, rec_err, idx_map).

    Batches of `batch_size` in site order, the ragged tail as one smaller
    batch. idx_map[i] is (image index, index within the image) of site i.
    The noise of each batch is the first rows of `eps` [batch_size, latent]
    where given, else a generator seeded 0 per batch (the JAX script's key(0)
    for every batch). Results stay on the device until the end: one transfer.
    Spans (`livae_tpu_torch.tracing`): `encode.pass`, one `encode.batch` a
    batch (its `indices`, `extract` and `forward`), then `host_copy`.
    """
    with span("encode.pass", new_tag=True):
        cum_lens = np.cumsum([0] + [len(c) for c in dataset.sample_coords])
        n = len(dataset)
        mus, logvars, errs = [], [], []
        for chunk in batched(np.arange(n), batch_size, drop_last=False):
            with span("encode.batch", new_tag=True):
                x = dataset.batch_at(chunk)  # transform=None: no augmentation
                noise = ((None, torch.Generator(device=x.device).manual_seed(0)) if eps is None
                         else (eps[: len(chunk)], None))
                with span("forward"):
                    mu, logvar, err = _batch_stats(model, x, is_rvae, *noise)
                mus.append(mu)
                logvars.append(logvar)
                errs.append(err)
        sites = np.arange(n)
        img_idx = np.searchsorted(cum_lens, sites, side="right") - 1
        idx_map = [(int(i), int(g - cum_lens[i])) for g, i in zip(sites, img_idx)]
        with span("host_copy"):
            return (
                torch.cat(mus).cpu().numpy(),
                torch.cat(logvars).cpu().numpy(),
                torch.cat(errs).cpu().numpy(),
                idx_map,
            )


def embed_latents(latent: np.ndarray, method: str = "auto", seed: int = 42) -> np.ndarray:
    """t-SNE (perplexity min(30, n - 1), at least 2) with a PCA fallback."""
    from sklearn.decomposition import PCA

    emb = None
    if method in ("auto", "tsne"):
        try:
            from sklearn.manifold import TSNE

            emb = TSNE(
                n_components=2,
                random_state=np.random.RandomState(seed),
                init="random",
                perplexity=min(30, max(2, len(latent) - 1)),
            ).fit_transform(latent)
        except Exception:
            emb = None
    if emb is None:
        emb = PCA(n_components=2).fit_transform(latent)
    return emb


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_latents(emb, out_path: Path, image_sources=None):
    plt = _pyplot()
    plt.figure(figsize=(6, 6))
    if image_sources is None:
        plt.scatter(emb[:, 0], emb[:, 1], s=8)
    else:
        cmap = plt.get_cmap("tab10")
        for i, img_idx in enumerate(np.unique(image_sources)):
            mask = image_sources == img_idx
            plt.scatter(
                emb[mask, 0], emb[mask, 1], s=8, color=cmap(i % 10),
                label=f"Image {img_idx} (n={mask.sum()})", alpha=0.8,
            )
        plt.legend(markerscale=2)
    plt.xlabel("dim-1")
    plt.ylabel("dim-2")
    plt.title("Latent Embedding")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close()
    print(f"Saved plot to: {out_path}")


def cluster_labels(mu: np.ndarray, n_clusters: int) -> np.ndarray:
    """KMeans(n_clusters, n_init 10, random_state 42) labels of the latents."""
    from sklearn.cluster import KMeans

    return KMeans(n_clusters=n_clusters, n_init=10, random_state=42).fit_predict(mu)


def plot_clusters_on_images(mu, idx_map, dataset, n_clusters=3, out_dir: Path = None):
    """KMeans patch cluster maps, one per image; coordinates are (y, x)."""
    plt = _pyplot()
    out_dir.mkdir(parents=True, exist_ok=True)
    labels = cluster_labels(mu, n_clusters)

    img_patch_labels = defaultdict(list)
    for (img_idx, local_idx), label in zip(idx_map, labels):
        img_patch_labels[img_idx].append((local_idx, label))

    half = dataset.patch_size // 2
    for img_idx, patches in img_patch_labels.items():
        coords = dataset.sample_coords[img_idx]
        cluster_map = np.zeros(dataset.images[img_idx].shape, dtype=int) - 1
        for local_idx, label in patches:
            y, x = map(int, coords[local_idx])
            cluster_map[max(0, y - half) : y + half, max(0, x - half) : x + half] = label
        plt.figure(figsize=(6, 6))
        plt.imshow(cluster_map, cmap="tab10", interpolation="none")
        plt.title(f"Image {img_idx} - Patch Clusters")
        plt.colorbar(label="Cluster ID")
        plt.axis("off")
        plt.tight_layout()
        path = out_dir / f"image_{img_idx}_clusters.png"
        plt.savefig(path, dpi=150)
        plt.close()
        print(f"Saved cluster map for image {img_idx} to {path}")


def plot_windows(mu, idx_map, window_sizes=(10, 20, 30, 60, 90, 120), out_dir: Path = None):
    """Latent histogram and scatter, one figure per window size."""
    plt = _pyplot()
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = np.array([i for i, _ in idx_map])
    for ws in window_sizes:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        ax1.hist(mu[:, 0], bins=40, color="green")
        ax1.set_xlabel("Encoded angle", fontsize=16)
        ax1.set_ylabel("Count", fontsize=16)
        ax1.set_title(f"Window size = {ws}", fontsize=16)
        d1 = 1 if mu.shape[1] > 1 else 0
        d2 = 2 if mu.shape[1] > 2 else d1
        sc = ax2.scatter(mu[:, d1], mu[:, d2], c=frames, cmap="viridis", s=8)
        ax2.set_xlabel("Latent 1", fontsize=16)
        ax2.set_ylabel("Latent 2", fontsize=16)
        plt.colorbar(sc, ax=ax2).set_label("Frame", fontsize=14)
        plt.tight_layout()
        path = out_dir / f"latent_hist_scatter_ws{ws}.png"
        plt.savefig(path, dpi=150)
        plt.close()
        print(f"Saved latent histogram & scatter for window size {ws} to {path}")


def plot_atom_clusters(mu, idx_map, dataset, n_clusters=3, out_dir: Path = None):
    """Atom-level scatter cluster maps, one per image."""
    plt = _pyplot()
    out_dir.mkdir(parents=True, exist_ok=True)
    labels = cluster_labels(mu, n_clusters)

    img_atoms = defaultdict(list)
    for (img_idx, local_idx), label in zip(idx_map, labels):
        y, x = dataset.sample_coords[img_idx][local_idx]
        img_atoms[img_idx].append((x, y, label))

    cmap = plt.get_cmap("tab10")
    for img_idx, atoms in img_atoms.items():
        atoms = np.array(atoms)
        x, y, lbls = atoms[:, 0], atoms[:, 1], atoms[:, 2].astype(int)
        plt.figure(figsize=(6, 6))
        for cl in range(n_clusters):
            mask = lbls == cl
            plt.scatter(x[mask], y[mask], s=10, color=cmap(cl % 10),
                        label=f"Cluster {cl}", alpha=0.8)
        plt.gca().invert_yaxis()
        plt.title(f"Image {img_idx} - Atom Clusters")
        plt.xlabel("X")
        plt.ylabel("Y")
        plt.legend(markerscale=2)
        plt.axis("equal")
        plt.tight_layout()
        path = out_dir / f"image_{img_idx}_atom_clusters.png"
        plt.savefig(path, dpi=150)
        plt.close()
        print(f"Saved atom-level cluster plot for image {img_idx} to {path}")


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Latent embeddings + cluster maps")
    add_data_flags(parser)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/vae_best.pt")
    parser.add_argument("--rvae", action="store_true", help="Force rVAE model type")
    parser.add_argument("--vae", action="store_true", help="Force plain VAE model type")
    parser.add_argument("--padding", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--n-clusters", type=int, default=3)
    parser.add_argument("--plots-dir", type=str, default="plots")
    parser.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    return parser


def load_for_analysis(args, force_type: str | None, images=None):
    """The shared start of the analysis scripts: the device (kernels built on
    the card), the checkpoint's model and the un-augmented dataset of the
    frames (`images`, default those the data flags name), normalised as the
    checkpoint was trained. Returns (model, is_rvae, dataset)."""
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device)
    model, is_rvae, latent_dim, patch_size, payload = load_model_from_checkpoint(
        args.checkpoint, force_type, device
    )
    normalize = checkpoint_normalize(payload)
    print(
        f"Loaded {'rVAE' if is_rvae else 'VAE'} (latent {latent_dim}, "
        f"patch {patch_size}, per-patch norm {'on' if normalize else 'off'})"
    )
    dataset = AdaptiveLatticeDataset(
        resolve_images(args) if images is None else images, patch_size=patch_size, padding=args.padding, transform=None,
        normalize=normalize, device=device,
    )
    return model, is_rvae, dataset


def main(argv=None):
    args = build_argparser().parse_args(argv)
    force = "rvae" if args.rvae else ("vae" if args.vae else None)
    model, is_rvae, dataset = load_for_analysis(args, force)

    print("Extracting latent vectors...")
    mu, logvar, rec_err, idx_map = collect_stats(model, dataset, args.batch_size, is_rvae)
    image_sources = np.array([i for i, _ in idx_map])
    print("Samples per image:", dict(zip(*np.unique(image_sources, return_counts=True))))

    plots = Path(args.plots_dir)
    print("Embedding latents...")
    emb = embed_latents(mu)
    plot_latents(emb, plots / "latent_embeddings.png", image_sources=image_sources)
    plot_clusters_on_images(mu, idx_map, dataset, args.n_clusters, plots / "clusters")
    plot_windows(mu, idx_map, out_dir=plots / "windows")
    plot_atom_clusters(mu, idx_map, dataset, args.n_clusters, plots / "atom_clusters")


if __name__ == "__main__":
    main()
