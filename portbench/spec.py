"""The registry: every cell, configuration, traffic mix, limit and per-layer
metric is found by its name in `BENCHMARK.json`, each in a file of its own.

    configs/<config>.json      the configuration as it is run (BENCHMARK.json's "file")
    traffic/<traffic>.json     a traffic mix: its loop (loops/<loop>.py) and parameters
    limits/<cell>.json         the limit of each number the cell compares
    metrics/<metric>.py        a per-layer metric's reader: read(ctx) -> float | None

A configuration's "model" is one of MODELS: the loops, the FLOP counts and
the plain reference (reference/rvae.py, reference/vae.py) know those two.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MODELS = ("rvae", "vae")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    if cfg["model"] not in MODELS:
        raise ValueError(f"{entry['file']}: model {cfg['model']!r} is none of {MODELS}")
    return cfg


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]


def loop(name: str):
    return importlib.import_module(f"portbench.loops.{name}")


def metric_reader(name: str):
    """metrics/<name>.py as a module (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_for(cell: str, kind: str, bench: dict | None = None) -> list[dict]:
    """The end_to_end ("end_to_end") or per-layer ("per_layer") metrics a cell reports."""
    bench = bench or benchmark()
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
