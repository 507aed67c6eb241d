#!/usr/bin/env python
"""The vacancy-regime accuracy program (port of scripts/accuracy_program.py).

Run as  python -m livae_tpu_torch.scripts.accuracy_program --epochs 30 --out accuracy_results.json
        python -m livae_tpu_torch.scripts.accuracy_program --quick --cpu   (seconds)

A grid of configs over beta and the per-patch-normalisation ablation (or the
top-k configs of a sweep's results.json or a best_config.json with
--configs-json), each trained with the fused paired rVAE step (AdamW with a
cosine rate, beta annealing, canonical weight 0.2, clip 20) on synthetic MoS2
frames with S vacancies, then scored on a held-out frame whose every site is
encoded by `visualizations.collect_stats`:

* KMeans(k=3) adjusted Rand index against the true Mo / S / vacancy classes,
  logistic-regression accuracy and the vacancy-vs-rest ROC AUC (sklearn);
* the mean KLD and the latent means' spread;
* the rot90 cosine of mu(x) and mu(rot90 x) on 256 probes.

Writes one JSON row per config and seed to --out, and with --seeds > 1 the
mean and spread per config to <out>.summary.json. The JAX script's flags and
row keys. Where sklearn is not importable, the run still trains and encodes
and says which metrics it skipped (they are NaN in the rows). Runs on the CUDA
device unless --cpu is given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time

import numpy as np
import torch

from ..data.datasets import AdaptiveLatticeDataset, PairedAdaptiveLatticeDataset, default_transform
from ..data.synthetic import synthetic_mos2_frame
from ..device import resolve_device
from ..models.rvae import RVAE
from ..train.engine import make_fused_rvae_train_step, metrics_to_host
from ..train.state import beta_at_epoch, cosine_annealing, make_optimizer, make_schedule
from ._common import prebuild_kernels, stream_generator
from .visualizations import collect_stats

__all__ = ["sweep_row_rank", "site_truth_labels", "latent_metrics", "rot90_cosine",
           "run_config", "summarize_seeds", "main", "build_argparser"]

SKLEARN_METRICS = ("kmeans_ari", "linear_accuracy", "vacancy_auc")


def sweep_row_rank(row: dict):
    """Sort key for --configs-json top-k selection: finished trials first (an
    early-stopped trial's loss does not compare with a finished one's), then
    by val_loss; rows without val_loss last."""
    return (
        row.get("status", "done") != "done",
        row.get("val_loss") if row.get("val_loss") is not None else float("inf"),
    )


def site_truth_labels(sites, truth, tol_frac: float = 0.35):
    """Match dataset sites to the ground truth's Mo (0) / S (1) / vacancy (2)
    classes. Returns (labels [N], mask [N] of matched sites)."""
    from scipy.spatial import cKDTree

    spacing = truth["spacing"]
    tol = spacing * tol_frac
    mo = np.asarray(truth["mo_sites"])
    s_all = np.asarray(truth["s_sites"])
    s_vac = np.asarray(truth["s_vacancies"])

    def dist_to(points):
        if len(points) == 0:
            return np.full(len(sites), np.inf)
        d, _ = cKDTree(points).query(sites)
        return d

    d_mo, d_s, d_vac = dist_to(mo), dist_to(s_all), dist_to(s_vac)
    labels = np.full(len(sites), -1, dtype=np.int64)
    # vacancies are a subset of s_sites: check them first
    labels[d_vac < tol] = 2
    is_mo = (labels == -1) & (d_mo < tol) & (d_mo <= d_s)
    labels[is_mo] = 0
    is_s = (labels == -1) & (d_s < tol)
    labels[is_s] = 1
    return labels, labels >= 0


def _moment_metrics(mu, logvar) -> dict:
    return {
        "kld_mean": float(np.mean(0.5 * np.sum(mu**2 + np.exp(logvar) - 1.0 - logvar, axis=1))),
        "latent_std_mean": float(np.mean(np.std(mu, axis=0))),
    }


def latent_metrics(mu, logvar, labels):
    """Clustering and linear-decodability metrics of the latent means (sklearn)."""
    from sklearn.cluster import KMeans
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import adjusted_rand_score, roc_auc_score
    from sklearn.model_selection import train_test_split
    from sklearn.preprocessing import StandardScaler

    mu = np.asarray(mu, dtype=np.float64)
    out = {}
    km = KMeans(n_clusters=3, n_init=10, random_state=0).fit(mu)
    out["kmeans_ari"] = float(adjusted_rand_score(labels, km.labels_))

    Xtr, Xte, ytr, yte = train_test_split(mu, labels, test_size=0.3, random_state=0,
                                          stratify=labels)
    scaler = StandardScaler().fit(Xtr)
    clf = LogisticRegression(max_iter=2000, class_weight="balanced").fit(
        scaler.transform(Xtr), ytr)
    out["linear_accuracy"] = float(clf.score(scaler.transform(Xte), yte))
    # vacancy-vs-rest AUC
    vac_tr, vac_te = (ytr == 2).astype(int), (yte == 2).astype(int)
    if vac_tr.sum() > 1 and vac_te.sum() > 1:
        clf2 = LogisticRegression(max_iter=2000, class_weight="balanced").fit(
            scaler.transform(Xtr), vac_tr)
        out["vacancy_auc"] = float(
            roc_auc_score(vac_te, clf2.predict_proba(scaler.transform(Xte))[:, 1]))
    else:
        out["vacancy_auc"] = float("nan")
    out.update(_moment_metrics(mu, logvar))
    return out


def sklearn_available() -> bool:
    return importlib.util.find_spec("sklearn") is not None


@torch.no_grad()
def rot90_cosine(model, x: torch.Tensor) -> float:
    """Mean cosine similarity of mu(x) and mu(rot90 x) over the probes x
    [B, 1, P, P] (the reference's verify_rotational_invariance metric)."""
    mu0 = model.encode(x)[0].double().cpu().numpy()
    mu1 = model.encode(torch.rot90(x, 1, dims=(2, 3)))[0].double().cpu().numpy()
    num = np.sum(mu0 * mu1, axis=1)
    den = np.linalg.norm(mu0, axis=1) * np.linalg.norm(mu1, axis=1) + 1e-12
    return float(np.mean(num / den))


def run_config(cfg, train_ds, eval_ds, eval_labels, eval_mask, args, seed=None) -> dict:
    """Train one config (from a generator of (seed, "init")) and score it on
    `eval_ds` (an un-augmented dataset of the held-out frame with the config's
    normalisation), whose sites `eval_labels` / `eval_mask` label."""
    device = train_ds.device
    seed = args.seed if seed is None else seed
    t0 = time.time()
    latent_dim = int(cfg.get("latent_dim") or args.latent_dim)
    model = RVAE(latent_dim, 1, args.patch_size,
                 "bfloat16" if device.type == "cuda" else None, device=device,
                 generator=stream_generator(seed, "init", 0, "cpu"))
    n = len(train_ds)
    batch = min(args.batch_size, n)
    steps = max(1, n // batch)
    rate = cosine_annealing(cfg["lr"], args.epochs * steps)
    optimizer = make_optimizer(model, rate, optimizer="adamw", weight_decay=1e-5)
    step = make_fused_rvae_train_step(
        model, optimizer, patch_size=args.patch_size, padding=args.padding,
        cfg=train_ds.transform, margin=train_ds._margin, canonical_weight=0.2,
        grad_max_norm=20.0, normalize=cfg["normalize"], scheduler=make_schedule(optimizer, rate),
        device=device,
    )
    tm = {}
    for epoch in range(args.epochs):
        beta_e = beta_at_epoch(epoch, cfg["beta"], anneal=args.beta_annealing, warmup_epochs=5,
                               ramp_epochs=15)
        gen = stream_generator(seed, "train", epoch, device)
        idx_batches = train_ds.epoch_index_batches(gen, batch)
        tm = metrics_to_host(step(*train_ds.device_site_table[:3], idx_batches, gen, beta_e,
                                  cfg["gamma"]))
    train_time = time.time() - t0

    # held-out evaluation: every site of the held-out frame
    model.eval()
    mu, logvar, _, _ = collect_stats(model, eval_ds, min(512, len(eval_ds)), is_rvae=True)
    mu, logvar = mu[eval_mask], logvar[eval_mask]
    if sklearn_available():
        metrics = latent_metrics(mu, logvar, eval_labels[eval_mask])
    else:
        metrics = {k: float("nan") for k in SKLEARN_METRICS}
        metrics.update(_moment_metrics(np.asarray(mu, np.float64), logvar))
    probe = eval_ds.batch_at(np.arange(min(256, len(eval_ds))))
    metrics["rot90_mu_cosine"] = rot90_cosine(model, probe)
    metrics.update(
        config=dict(cfg, beta_annealing=args.beta_annealing, epochs=args.epochs),
        seed=int(seed),
        train_loss=float(tm.get("loss", np.nan)),
        train_seconds=round(train_time, 1),
        eval_sites=int(eval_mask.sum()),
        train_rotation_std=float(tm.get("rotation_std", np.nan)),
        train_kld=float(tm.get("kld_loss", np.nan)),
    )
    return metrics


_SUMMARY_KEYS = ("kmeans_ari", "linear_accuracy", "vacancy_auc", "kld_mean", "rot90_mu_cosine")


def summarize_seeds(results) -> list[dict]:
    """Mean and spread per (beta, normalize, lr, latent_dim, gamma) config
    across seeds."""
    groups: dict[tuple, list[dict]] = {}
    for r in results:
        c = r["config"]
        k = (c["beta"], c["normalize"], c.get("lr"), c.get("latent_dim"), c.get("gamma"))
        groups.setdefault(k, []).append(r)
    rows = []
    for (beta, normalize, lr, latent_dim, gamma), rs in groups.items():
        row = {"beta": beta, "normalize": normalize, "lr": lr, "latent_dim": latent_dim,
               "gamma": gamma, "n_seeds": len(rs), "seeds": [r["seed"] for r in rs]}
        for key in _SUMMARY_KEYS:
            vals = np.asarray([r[key] for r in rs], dtype=float)
            row[f"{key}_mean"] = float(np.nanmean(vals)) if np.isfinite(vals).any() else float("nan")
            row[f"{key}_std"] = float(np.nanstd(vals)) if np.isfinite(vals).any() else float("nan")
        rows.append(row)
    return rows


def main(args) -> list[dict]:
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device)
    print(f"Vacancy regime: {args.train_frames}x {args.size}^2 frames, spacing {args.spacing}, "
          f"vacancy rate {args.vacancy_rate}, s_amplitude {args.s_amplitude}")
    frame_kw = dict(size=args.size, spacing=args.spacing, vacancy_rate=args.vacancy_rate,
                    s_amplitude=args.s_amplitude)
    train_frames = [synthetic_mos2_frame(**frame_kw, seed=s)[0] for s in range(args.train_frames)]
    held_frame, held_truth = synthetic_mos2_frame(**frame_kw, seed=args.train_frames + 17)

    train_ds = PairedAdaptiveLatticeDataset(train_frames, patch_size=args.patch_size,
                                            padding=args.padding, transform=default_transform,
                                            device=device)
    eval_sets: dict[bool, AdaptiveLatticeDataset] = {}

    def eval_ds(normalize: bool) -> AdaptiveLatticeDataset:
        if normalize not in eval_sets:
            eval_sets[normalize] = AdaptiveLatticeDataset(
                [held_frame], patch_size=args.patch_size, padding=args.padding, transform=None,
                normalize=normalize, device=device)
        return eval_sets[normalize]

    eval_labels, eval_mask = site_truth_labels(eval_ds(True).sample_coords[0], held_truth)
    n_by_class = [int((eval_labels == c).sum()) for c in (0, 1, 2)]
    print(f"Train: {len(train_ds)} sites | held-out: {len(eval_ds(True))} sites, "
          f"matched Mo/S/vac = {n_by_class}")
    if not sklearn_available():
        print(f"note: sklearn is not importable here: skipped {', '.join(SKLEARN_METRICS)} "
              "(NaN in the rows); kld_mean, latent_std_mean and rot90_mu_cosine are computed")

    if args.configs_json:
        # score configs chosen elsewhere (a sweep's results.json rows, ranked,
        # or a best_config.json) on the vacancy metrics
        with open(args.configs_json) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            raw = [raw]
        raw = sorted(raw, key=sweep_row_rank)
        configs = []
        for row in raw[: args.top_k]:
            c = row.get("config", row)
            configs.append({
                "beta": float(c.get("beta", 1.0)),
                "gamma": float(c.get("gamma") or args.gamma),
                "lr": float(c.get("lr", args.lr)),
                "normalize": bool(c.get("normalize", True)),
                "latent_dim": int(c.get("latent_dim") or args.latent_dim),
            })
        print(f"Scoring {len(configs)} configs from {args.configs_json}")
    else:
        configs = [{"beta": beta, "gamma": args.gamma, "lr": args.lr, "normalize": normalize}
                   for beta in args.betas
                   for normalize in ([True, False] if args.norm_ablation else [True])]

    results = []
    total = len(configs) * args.seeds
    for i, cfg in enumerate(configs):
        for s in range(args.seeds):
            seed = args.seed + 1000 * s
            print(f"[{i * args.seeds + s + 1}/{total}] {cfg} seed={seed} ...", flush=True)
            m = run_config(cfg, train_ds, eval_ds(cfg["normalize"]), eval_labels, eval_mask,
                           args, seed=seed)
            print(f"  ARI {m['kmeans_ari']:.3f} | lin-acc {m['linear_accuracy']:.3f} | "
                  f"vac-AUC {m['vacancy_auc']:.3f} | kld {m['kld_mean']:.3f} | "
                  f"rot90-cos {m['rot90_mu_cosine']:.3f} | {m['train_seconds']}s", flush=True)
            results.append(m)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    if args.seeds > 1:
        summary = summarize_seeds(results)
        spath = args.out + ".summary.json"
        with open(spath, "w") as f:
            json.dump(summary, f, indent=2)
        print("\nmean ± std across seeds:")
        for row in summary:
            print(f"  beta {row['beta']:<5} norm {str(row['normalize']):<5} "
                  f"({row['n_seeds']} seeds): "
                  + " | ".join(f"{k} {row[f'{k}_mean']:.3f}±{row[f'{k}_std']:.3f}"
                               for k in _SUMMARY_KEYS))
        print(f"Summary written to {spath}")
    print(f"Results written to {args.out}")
    return results


def build_argparser():
    p = argparse.ArgumentParser(description="Vacancy-regime accuracy program")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spacing", type=float, default=40.0)
    p.add_argument("--vacancy-rate", type=float, default=0.12)
    p.add_argument("--s-amplitude", type=float, default=0.45)
    p.add_argument("--train-frames", type=int, default=3)
    p.add_argument("--patch-size", type=int, default=128)
    p.add_argument("--padding", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=10.0)
    p.add_argument("--betas", type=float, nargs="+", default=[0.1, 0.5, 1.0, 10.0])
    p.add_argument(
        "--beta-annealing", action="store_true", default=True,
        help="0 during 5 warmup epochs, 15-epoch linear ramp to beta "
        "(the production train_rvae recipe)",
    )
    p.add_argument("--no-beta-annealing", dest="beta_annealing", action="store_false")
    p.add_argument("--norm-ablation", action="store_true", default=True)
    p.add_argument("--no-norm-ablation", dest="norm_ablation", action="store_false")
    p.add_argument("--out", type=str, default="accuracy_results.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--seeds", type=int, default=1,
        help="Seeds per config; >1 also writes <out>.summary.json with "
        "mean±std across seeds",
    )
    p.add_argument(
        "--configs-json", type=str, default=None,
        help="Score configs from a JSON file (sweep results.json rows or "
        "best_config.json) instead of the beta x norm grid",
    )
    p.add_argument("--top-k", type=int, default=5,
                   help="With --configs-json: score at most this many configs")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    p.add_argument("--quick", action="store_true", help="tiny smoke run")
    return p


def parse_args(argv=None):
    """The flags, with --quick's tiny sizes applied (the JAX script's)."""
    args = build_argparser().parse_args(argv)
    if args.quick:
        args.size, args.spacing, args.train_frames = 512, 40.0, 1
        args.patch_size, args.padding, args.batch_size = 32, 8, 64
        args.epochs, args.betas = 2, [1.0]
    return args


if __name__ == "__main__":
    main(parse_args())
