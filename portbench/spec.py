"""The registry: every cell, configuration, traffic mix, limit, per-layer
metric and model is found by its name, each in a file of its own.

    configs/<config>.json      the configuration as it is run (BENCHMARK.json's "file")
    traffic/<traffic>.json     a traffic mix: its loop (loops/<loop>.py) and parameters
    limits/<cell>.json         the limit of each number the cell compares
    metrics/<metric>.py        a per-layer metric's reader: read(ctx) -> float | None
    models/<model>.py          a model's binding (models/__init__.py gives its interface):
                               the program's pieces, the plain reference, the counts

A configuration's "model" names its binding. The loops, the readers, the
counts and the reference's drive reach every model through its binding
alone, so a new architecture is new files: models/<model>.py,
reference/<model>.py, configs/<config>.json, limits/<cell>.json and its
entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pkgutil
from pathlib import Path

from . import models as _bindings

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def models() -> tuple[str, ...]:
    """The models that have a binding: the modules of the models package."""
    return tuple(sorted(m.name for m in pkgutil.iter_modules(_bindings.__path__)))


MODELS = models()


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
    if cfg["model"] not in models():
        raise ValueError(f"{entry['file']}: {_unbound(cfg['model'])}")
    return cfg


def _unbound(model: str) -> str:
    return f"model {model!r} has no binding; models/ binds {', '.join(models())}"


def binding(model: str):
    """models/<model>.py as a module."""
    if model not in models():
        raise ValueError(_unbound(model))
    return importlib.import_module(f"{_bindings.__name__}.{model}")


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
