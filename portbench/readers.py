"""Arithmetic the per-layer metrics (metrics/*.py) share: kernels of the
traced window, the hand-written operations' bounds against the time of the
kernels mapped to them, the idle share, the model FLOPs' share of the peak.
A reader that finds nothing to read returns None."""

from __future__ import annotations

import json
import re
from pathlib import Path

from .counts import ops as counts
from .trace import Trace, busy_us

KERNEL_MAP = json.loads((Path(__file__).resolve().parent / "counts" / "kernel_map.json").read_text())
ELEM = {"bfloat16": 2, "float32": 4, None: 4}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def kernels_between(trace: Trace, start: float, end: float) -> int | None:
    """Kernels that start within [start, end); None where the trace saw no device."""
    if not trace.ops:
        return None
    return sum(is_kernel(o[0]) for o in trace.ops_in(start, end))


def mapped_time_us(trace: Trace, operations) -> float:
    """Device time of the kernels the kernel map gives to `operations`."""
    pats = [re.compile(p) for op in operations for p in KERNEL_MAP["operations"][op]]
    return sum(b - a for name, a, b in trace.ops if any(p.search(name) for p in pats))


def roofline_pct(trace: Trace, work: list[tuple[str, int]]) -> float | None:
    """100 x (the least time the work's bytes take at the HBM rate) over the
    device time of the kernels mapped to its operations."""
    t = mapped_time_us(trace, {op for op, _ in work}) * 1e-6
    if t <= 0:
        return None
    bound = sum(b for _, b in work) / counts.PEAKS["hbm_bytes_per_s"]
    return 100.0 * bound / t


def idle_pct(trace: Trace) -> float | None:
    start, end = trace.window
    if end <= start or not trace.ops:
        return None
    return 100.0 * (1.0 - busy_us(trace) / (end - start))


def train_work(ctx) -> list[tuple[str, int]]:
    """The hand-written operations of the traced window's train steps and eval batches."""
    cfg, info = ctx.config, ctx.trace.info
    if cfg["model"] != "rvae":
        return []
    elem = ELEM[cfg["precision"]["compute_dtype"]]
    S, pad = cfg["patch_size"], cfg["padding"]
    work = counts.rvae_ops(S, pad, info["batch"], elem, train=True, paired=True,
                           augmented_rotation=True) * info["steps"]
    for b in info["eval_batches"]:
        work += counts.rvae_ops(S, pad, b, elem, train=False, paired=True, augmented_rotation=True)
    return work


def encode_work(ctx) -> list[tuple[str, int]]:
    """The hand-written operations of the traced passes (float32, no augmentation)."""
    cfg, info = ctx.config, ctx.trace.info
    per_pass = []
    for b in info["batches"]:
        per_pass += counts.rvae_ops(cfg["patch_size"], ctx.traffic["padding"], b, 4, train=False,
                                    paired=False, augmented_rotation=False)
    return per_pass * info["passes"]


def mfu_pct(flops: float, seconds: float, precision: str) -> float | None:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / counts.PEAKS["flops_per_s"][precision]
