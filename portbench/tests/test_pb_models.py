"""The model bindings: a model that only new files name runs a cell through
the harness; the shared files hold no model's name, compare no
configuration's model with one and import no model class; the bindings of
the two models count what counts/ops.py counted before they moved there."""

import ast
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, models, readers, spec
from portbench.counts import ops
from portbench.tests.test_pb_loops import (SEED, _altered_latent, _half_batch,  # noqa: F401
                                           _threads, tiny)
from portbench.trace import Trace

CPU = torch.device("cpu")
BINDINGS = Path(__file__).resolve().parent / "bindings"
TWIN = "twinvae"
CELLS = {"train": ("vae128.train", _half_batch), "analyze": ("rvae128.analyze", _altered_latent)}
# The twin's analysis limits: rec_err's as rvae128.analyze's, mu's and
# logvar's raw gaps at 1e-3 (the port's float32 pass and the reference's
# read 0 here; one site in ten given its neighbour's mu reads about 0.9).
ANALYZE_LIMITS = {"site_count_gap": 0, "err_gap_q99": 1e-5, "err_gap_max": 1.6e-5,
                  "mu_gap_max": 1e-3, "logvar_gap_max": 1e-3}


@pytest.fixture
def twin(tmp_path, monkeypatch):
    """The benchmark's registry copied, and a model that no shared file names
    added by new files and entries alone: its binding (found on the models
    package's path), its configuration, a training and an analysis cell
    (each listed where vae128.train or rvae128.analyze is) and their limits."""
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.HERE / d, here / d)
    bench = spec.benchmark()
    cfg = spec.config("vae128")
    cfg = {**cfg, "name": "twin128", "model": TWIN,
           "precision": {**cfg["precision"],
                         "analyze": spec.config("rvae128")["precision"]["analyze"]}}
    (here / "configs" / "twin128.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "twin128", "source": "the tests", "reduced": [],
                             "file": "portbench/configs/twin128.json", "why": "the tests"})
    for traffic, (like, _) in CELLS.items():
        cell = f"twin128.{traffic}"
        bench["workloads"].append({"name": cell, "config": "twin128", "traffic": traffic,
                                   "chips": 1, "why": "the tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
        limits = ANALYZE_LIMITS if traffic == "analyze" else spec.limits(like)
        (here / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(models, "__path__", [*models.__path__, str(BINDINGS)])
    yield
    sys.modules.pop(f"{models.__name__}.{TWIN}", None)


@pytest.mark.parametrize("traffic", list(CELLS))
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_new_model_runs_a_cell(twin, traffic, traced):
    assert TWIN in spec.models() and TWIN not in spec.MODELS
    cell = f"twin128.{traffic}"
    out = harness.run_cell(cell, SEED, 0.5, traced, CPU, 0.0, tiny(cell, traffic == "train"))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(spec.limits(cell))
    kind = "per_layer" if traced else "end_to_end"
    listed = {m["name"] for m in spec.metrics_for(cell, kind)}
    assert set(out["metrics"]) <= listed
    if traced:  # no device here: the device's readers find nothing
        assert out["metrics"]["setup.dataset_build_s"]["value"] > 0
    else:
        assert set(out["metrics"]) == listed


@pytest.mark.parametrize("traffic", list(CELLS))
def test_new_model_planted_fault_is_not_correct(twin, traffic, monkeypatch):
    """Half of every batch left out (training); one site in ten given its
    neighbour's mu (analysis)."""
    CELLS[traffic][1](monkeypatch)
    cell = f"twin128.{traffic}"
    out = harness.run_cell(cell, SEED, 0.3, False, CPU, 0.0, tiny(cell, traffic == "train"))
    assert out["correct"] is False


def test_new_model_counts_and_kernels(twin):
    assert ops.train_flops(TWIN, 128, 16) == ops.train_flops("vae", 128, 16)
    cfg = spec.config("twin128")
    ctx = SimpleNamespace(config=cfg, trace=Trace(
        ops=[("twin_probe_kernel", 0.0, 10.0), ("other_kernel", 10.0, 30.0)],
        spans=[("step", 0.0, 30.0)], info={"steps": 2, "batch": 8, "eval_batches": [4]}))
    work = readers.train_work(ctx)
    assert work == [("twin_probe", 4096 * 8)] * 2
    # the binding's KERNELS map its operation to the probe's 10 us alone
    want = 100.0 * 2 * 4096 * 8 / ops.PEAKS["hbm_bytes_per_s"] / 10e-6
    assert readers.roofline_pct(ctx.trace, work) == pytest.approx(want)


def test_a_model_without_a_binding_is_refused():
    assert spec.MODELS == spec.models() and {"rvae", "vae"} <= set(spec.MODELS)
    with pytest.raises(ValueError, match=f"models/ binds {', '.join(spec.MODELS)}$"):
        spec.binding(TWIN)
    assert "twin_probe" not in readers.kernel_patterns()


# --- the shared files name no model ---

SHARED = ["loops/train.py", "loops/analyze.py", "reference/drive.py", "counts/ops.py",
          "readers.py", "spec.py"]
NAMES = {*spec.MODELS, TWIN}


def _docstrings(tree) -> set[int]:
    """ids of the string constants that are docstrings."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def _is_model_key(node) -> bool:
    """cfg["model"], or any other subscript by the key "model"."""
    return (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
            and node.slice.value == "model")


def _is_literal(node) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    return isinstance(node, (ast.Tuple, ast.List, ast.Set)) and all(map(_is_literal, node.elts))


@pytest.mark.parametrize("name", SHARED)
def test_shared_file_names_no_model(name):
    tree = ast.parse((spec.HERE / name).read_text())
    docs = _docstrings(tree)
    words = lambda s: set(s.replace(".", " ").replace("_", " ").replace("/", " ").split())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            assert not words(node.value) & NAMES, f"{name}:{node.lineno} {node.value!r}"
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            assert not (any(map(_is_model_key, operands)) and any(map(_is_literal, operands))), (
                f"{name}:{node.lineno} compares a configuration's model with a literal")
        if isinstance(node, ast.ImportFrom) and node.module:  # a model class by name
            assert not node.module.startswith("livae_tpu_torch.models"), f"{name}:{node.lineno}"


@pytest.mark.parametrize("path", sorted((spec.HERE / "models").glob("*.py")) + sorted(
    BINDINGS.glob("*.py")), ids=lambda p: p.name)
def test_binding_imports_the_program_inside_functions(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            assert not any(a.name.startswith("livae_tpu_torch") for a in node.names)
        if isinstance(node, ast.ImportFrom):
            assert not (node.module or "").startswith("livae_tpu_torch")


# --- the bindings count what counts/ops.py counted for them ---

RVAE_TRAIN_512 = [
    ("rot3_fwd", 135266304), ("phasemax_fwd", 738197536), ("phasemax_bwd", 738197504),
    ("phasemax_fwd", 369098816), ("phasemax_bwd", 369098752), ("rot3_fwd", 135266304),
    ("rot3_bwd", 136314880), ("upconv_fwd", 79692032), ("upconv_bwd", 125829120),
    ("upconv_fwd", 146800768), ("upconv_bwd", 226492416), ("upconv_fwd", 281018432),
    ("upconv_bwd", 427819008), ("upconv_fwd", 34340866), ("upconv_bwd", 35127296),
    ("rot3_fwd", 135266304), ("rot3_bwd", 203423744)]
RVAE_EVAL_301 = [
    ("rot3_fwd", 79521792), ("phasemax_fwd", 433979424), ("phasemax_fwd", 216989760),
    ("rot3_fwd", 79521792), ("upconv_fwd", 46850304), ("upconv_fwd", 86302848),
    ("upconv_fwd", 165208128), ("upconv_fwd", 20188674), ("rot3_fwd", 79521792)]
RVAE_ENCODE_1024 = [
    ("phasemax_fwd", 1409286208), ("phasemax_fwd", 704643200), ("rot3_fwd", 538968064),
    ("upconv_fwd", 318767616), ("upconv_fwd", 587202816), ("upconv_fwd", 1124073600),
    ("upconv_fwd", 137363460), ("rot3_fwd", 538968064)]
RVAE_ENCODE_240 = [330301504, 165150848, 126320640, 74711552, 137625856, 263454848, 32194564,
                   126320640]


@pytest.mark.parametrize("config,model,fwd,train", [
    ("rvae128", "rvae", 789577856, 2702705408), ("vae128", "vae", 412614656, 1233649664)])
def test_flops_as_before(config, model, fwd, train):
    cfg = spec.config(config)
    assert cfg["model"] == model
    assert ops.forward_flops(model, cfg["patch_size"], cfg["latent_dim"]) == fwd
    assert ops.train_flops(model, cfg["patch_size"], cfg["latent_dim"]) == train


@pytest.mark.parametrize("config,train,ev,encode", [
    ("rvae128", RVAE_TRAIN_512, RVAE_EVAL_301, RVAE_ENCODE_1024), ("vae128", [], [], [])])
def test_operations_as_before(config, train, ev, encode):
    cfg = spec.config(config)
    ops_of = spec.binding(cfg["model"]).kernel_ops
    assert ops_of("train", cfg, cfg["padding"], 512, 2) == train
    assert ops_of("eval", cfg, cfg["padding"], 301, 2) == ev
    assert ops_of("encode", cfg, 16, 1024, 4) == encode


@pytest.mark.parametrize("config,n,total", [("rvae128", 154, 37801032532), ("vae128", 0, 0)])
def test_train_window_work_as_before(config, n, total):
    """The readers' operations over a traced window of 8 steps of 512 and
    eval batches of 512 and 301."""
    ctx = SimpleNamespace(config=spec.config(config), trace=Trace(
        info={"steps": 8, "batch": 512, "eval_batches": [512, 301]}))
    work = readers.train_work(ctx)
    assert (len(work), sum(b for _, b in work)) == (n, total)


def test_encode_window_work_as_before():
    """The readers' operations over two analysis passes of 8 x 1024 and 240."""
    ctx = SimpleNamespace(config=spec.config("rvae128"), traffic=spec.traffic("analyze"),
                          trace=Trace(info={"passes": 2, "batches": [1024] * 8 + [240]}))
    work = readers.encode_work(ctx)
    assert (len(work), sum(b for _, b in work)) == (144, 88260529352)
    ctx.trace.info = {"passes": 1, "batches": [240]}
    assert [b for _, b in readers.encode_work(ctx)] == RVAE_ENCODE_240
