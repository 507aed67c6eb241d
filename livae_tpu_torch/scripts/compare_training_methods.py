#!/usr/bin/env python
"""Compare standard training with hyperparameter-search training (port of
scripts/compare_training_methods.py).

Run as  python -m livae_tpu_torch.scripts.compare_training_methods
            [--checkpoint checkpoints/rvae_best.pt] [--results-dir ray_results/rvae_tune]
            [--out plots/method_comparison.png]

Reads a standard run's checkpoint (its best_val, epoch and args) and a
sweep's results.json, prints the side-by-side summary and saves a bar plot.
matplotlib is imported for the plot only; where it is not installed the plot
is skipped with a line saying so.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..utils.checkpoint import load_checkpoint


def load_standard(ckpt_path: Path) -> dict | None:
    if not ckpt_path.exists():
        return None
    payload = load_checkpoint(ckpt_path)
    return {
        "method": "standard",
        "val_loss": float(payload.get("best_val", float("nan"))),
        "epochs": int(payload.get("epoch", -1)) + 1,
        "config": {
            k: payload.get("args", {}).get(k)
            for k in ("lr", "latent_dim", "beta", "batch_size")
        },
    }


def load_sweep(results_dir: Path) -> dict | None:
    path = results_dir / "results.json"
    if not path.exists():
        return None
    trials = json.loads(path.read_text())
    ok = [t for t in trials if t.get("val_loss") is not None]
    if not ok:
        return None
    best = min(ok, key=lambda t: t["val_loss"])
    return {
        "method": "sweep (best trial)",
        "val_loss": best["val_loss"],
        "epochs": best["epochs"],
        "config": {
            k: best["config"].get(k)
            for k in ("lr", "latent_dim", "beta", "batch_size")
        },
        "n_trials": len(trials),
    }


def plot_comparison(rows: list[dict], out: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out.parent.mkdir(parents=True, exist_ok=True)
    plt.figure(figsize=(5, 4))
    plt.bar(
        [r["method"] for r in rows],
        [r["val_loss"] for r in rows],
        color=["tab:blue", "tab:orange"][: len(rows)],
    )
    plt.ylabel("best val loss")
    plt.title("Standard vs sweep training")
    plt.tight_layout()
    plt.savefig(out, dpi=150)
    plt.close()
    print(f"Saved {out}")


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description="Compare training methods")
    parser.add_argument("--checkpoint", type=str, default="checkpoints/rvae_best.pt")
    parser.add_argument("--results-dir", type=str, default="ray_results/rvae_tune")
    parser.add_argument("--out", type=str, default="plots/method_comparison.png")
    args = parser.parse_args(argv)

    rows = []
    std = load_standard(Path(args.checkpoint))
    if std:
        rows.append(std)
    swp = load_sweep(Path(args.results_dir))
    if swp:
        rows.append(swp)

    if not rows:
        raise SystemExit("Nothing to compare: no checkpoint and no sweep results found")

    print(f"{'method':<22} {'val_loss':>10} {'epochs':>7}  config")
    print("-" * 78)
    for r in rows:
        cfg = ", ".join(f"{k}={v}" for k, v in r["config"].items() if v is not None)
        print(f"{r['method']:<22} {r['val_loss']:>10.4f} {r['epochs']:>7}  {cfg}")

    if len(rows) == 2 and all(np.isfinite(r["val_loss"]) for r in rows):
        better = min(rows, key=lambda r: r["val_loss"])
        delta = abs(rows[0]["val_loss"] - rows[1]["val_loss"])
        print(f"\n{better['method']} is better by {delta:.4f} val loss")

    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"skipped the plot {args.out}: {e}")
    else:
        plot_comparison(rows, Path(args.out))
    return rows


if __name__ == "__main__":
    main()
