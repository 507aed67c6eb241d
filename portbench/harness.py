"""One run of one cell: set-up, the measured window, the traced window
(with --trace 1), the peak memory, then the reference's comparison once the
program's state is freed, and the result line."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import spec, trace as T


def card(device) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(index)], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limited reading finite and within its limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device, t0: float,
             overrides: dict | None = None) -> dict:
    """Run a cell once and return its result line as a dict. `overrides`
    ({"config": {...}, "traffic": {...}}) resize a cell for the CPU tests."""
    bench = spec.benchmark()
    cell = spec.workload(cell_name, bench)
    cfg = {**spec.config(cell["config"], bench), **(overrides or {}).get("config", {})}
    traffic = {**spec.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    loop = spec.loop(traffic["loop"])
    spans = T.Spans()
    spans.done.append(("start", t0 - time.time() + time.perf_counter(), time.perf_counter()))
    run = loop.Run(cfg, traffic, seed, device, spans)
    run.setup()
    setup_s = time.time() - t0
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for n, a, b in spans.done)
          + f"; {setup_s:.3f} s in all", file=sys.stderr, flush=True)
    result = run.window(seconds)
    cuda = device.type == "cuda"
    trace = run.traced() if traced else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    evidence = run.close()
    readings = loop.compare(evidence, cfg, traffic, device)["program"]
    correct, checks = judge(readings, spec.limits(cell_name))
    correct = correct and result["failed"] == 0

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"]}
    if traced:
        ctx = SimpleNamespace(cell=cell, config=cfg, traffic=traffic, spans=spans, trace=trace,
                              window=run.window_info, setup_s=setup_s)
        metrics = {}
        for m in spec.metrics_for(cell_name, "per_layer", bench):
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        start, end = trace.window
        dev.update(busy_s=T.busy_us(trace) * 1e-6, window_s=(end - start) * 1e-6)
        out.update(metrics=metrics, device=dev, breakdown=T.breakdown(trace))
    else:
        units = {m["name"]: m["unit"] for m in spec.metrics_for(cell_name, "end_to_end", bench)}
        values = {**result["metrics"], "setup_s": setup_s}
        out.update(metrics={k: {"value": values[k], "unit": u} for k, u in units.items()},
                   device=dev)
    out["card"] = card(device) if cuda else "cpu"
    out["readings"] = {k: v for k, v in readings.items() if k not in checks}
    out["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    return out
