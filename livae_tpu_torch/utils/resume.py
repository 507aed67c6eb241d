"""Full-state resume checkpoints (the port's stand-in for
livae_tpu/utils/orbax_io.py).

The reference-format files (utils/checkpoint.py) hold the weights alone; a
run that must continue exactly also needs the optimizer's moments, the
schedule's count and the host's bookkeeping. One `torch.save` file per step,
`step_<n>.pt` under the resume directory, holds
{"state": {...state dicts...}, "meta": {"epoch", "best_val", "seed", ...}};
the newest two are kept.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

__all__ = ["save_train_state", "latest_step", "restore_train_state"]

_KEEP = 2
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def save_train_state(directory: str | Path, step: int, state: dict,
                     metadata: dict | None = None) -> None:
    """Write `state` (a dict of state dicts and plain values) and `metadata`
    as step `step`, then drop all but the newest files."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".step_{step}.pt.tmp"
    torch.save({"state": state, "meta": dict(metadata or {})}, tmp)
    os.replace(tmp, d / f"step_{step}.pt")
    for old in _steps(d)[:-_KEEP]:
        (d / f"step_{old}.pt").unlink()


def latest_step(directory: str | Path) -> int | None:
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def restore_train_state(directory: str | Path, step: int | None = None,
                        map_location="cpu") -> tuple[dict, dict]:
    """(state, metadata) of `step`, by default the newest; the caller loads the
    state dicts into its model, optimizer and schedule."""
    d = Path(directory)
    if step is None:
        step = latest_step(d)
    if step is None:
        raise FileNotFoundError(f"No resume checkpoints in {d}")
    payload = torch.load(d / f"step_{step}.pt", map_location=map_location, weights_only=False)
    meta = dict(payload["meta"])
    meta.setdefault("step", step)
    return payload["state"], meta
