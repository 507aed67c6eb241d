#!/usr/bin/env python
"""Analyze hyperparameter-search results: summary, top-k, CSV and plots (port
of scripts/analyze_raytune_results.py).

Run as  python -m livae_tpu_torch.scripts.analyze_raytune_results
            [--results-dir ray_results/rvae_tune] [--top-k 5] [--csv out.csv] [--plots]

Reads the results.json that train_rvae_raytune (livae_tpu_torch.sweep.run_search)
writes. Needs pandas, and matplotlib for --plots; both are imported where
they are used.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_results(results_dir: Path) -> list[dict]:
    path = results_dir / "results.json"
    if not path.exists():
        raise SystemExit(f"No results.json in {results_dir}")
    return json.loads(path.read_text())


def to_dataframe(trials: list[dict]):
    import pandas as pd

    rows = []
    for t in trials:
        row = {
            "trial_id": t["trial_id"],
            "status": t["status"],
            "epochs": t["epochs"],
            "loss": t.get("loss"),
            "val_loss": t.get("val_loss"),
        }
        row.update({f"config/{k}": v for k, v in t.get("config", {}).items()})
        rows.append(row)
    return pd.DataFrame(rows)


def summarize(df, top_k: int) -> None:
    print("=" * 70)
    print(f"Trials: {len(df)} | done: {(df.status == 'done').sum()} | "
          f"stopped: {(df.status == 'stopped').sum()} | errors: {(df.status == 'error').sum()}")
    ok = df[df.loss.notna()]
    if len(ok) == 0:
        print("No trials with reported loss.")
        return
    print(f"loss: best {ok.loss.min():.4f} | median {ok.loss.median():.4f} | "
          f"worst {ok.loss.max():.4f}")
    print("=" * 70)
    print(f"Top {top_k} configurations:")
    cols = [c for c in ok.columns if c.startswith("config/") and ok[c].nunique() > 1]
    top = ok.nsmallest(top_k, "loss")
    for _, row in top.iterrows():
        cfg = ", ".join(f"{c.split('/')[1]}={row[c]:.4g}" if isinstance(row[c], float)
                        else f"{c.split('/')[1]}={row[c]}" for c in cols)
        print(f"  trial {int(row.trial_id):3d}: loss={row.loss:.4f}  {cfg}")


def plot_scatter(df, out_dir: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    ok = df[df.loss.notna()]
    hp_cols = [
        c for c in ok.columns
        if c.startswith("config/")
        and pd.api.types.is_numeric_dtype(ok[c])
        and ok[c].nunique() > 1
    ]
    if not hp_cols:
        return
    n = len(hp_cols)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for ax, col in zip(axes[0], hp_cols):
        ax.scatter(ok[col], ok.loss, s=14, alpha=0.7)
        name = col.split("/", 1)[1]
        if name in ("lr", "beta", "weight_decay"):
            ax.set_xscale("log")
        ax.set_xlabel(name)
        ax.set_ylabel("loss")
    plt.tight_layout()
    path = out_dir / "hyperparam_vs_loss.png"
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"Saved {path}")


def plot_learning_curves(trials: list[dict], out_dir: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(7, 5))
    for t in trials:
        hist = t.get("history", [])
        xs = [m["epoch"] for m in hist if "val_loss" in m]
        ys = [m["val_loss"] for m in hist if "val_loss" in m]
        if xs:
            plt.plot(xs, ys, alpha=0.6, label=f"trial {t['trial_id']}")
    plt.xlabel("epoch")
    plt.ylabel("val_loss")
    plt.title("Learning curves")
    if len(trials) <= 12:
        plt.legend(fontsize=7)
    plt.tight_layout()
    path = out_dir / "learning_curves.png"
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"Saved {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Analyze sweep results")
    parser.add_argument(
        "--results-dir", type=str, default="ray_results/rvae_tune",
        help="Directory containing results.json",
    )
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--csv", type=str, default=None, help="Export CSV path")
    parser.add_argument("--plots", action="store_true", help="Write analysis plots")
    args = parser.parse_args(argv)

    results_dir = Path(args.results_dir)
    trials = load_results(results_dir)
    df = to_dataframe(trials)
    summarize(df, args.top_k)

    if args.csv:
        Path(args.csv).parent.mkdir(parents=True, exist_ok=True)
        df.to_csv(args.csv, index=False)
        print(f"Exported {args.csv}")
    if args.plots:
        plot_scatter(df, results_dir)
        plot_learning_curves(trials, results_dir)


if __name__ == "__main__":
    main()
