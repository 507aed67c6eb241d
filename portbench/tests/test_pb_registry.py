"""The registry: every name in BENCHMARK.json leads to its own files, and the
file keeps to the contract's shape."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = spec.config(cfg["name"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    assert data["model"] in spec.MODELS
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and NAME.match(cell["name"]) and len(cell["why"]) <= 200
    traffic = spec.traffic(cell["traffic"])
    assert (spec.HERE / "loops" / f"{traffic['loop']}.py").exists()
    assert spec.limits(cell["name"])
    e2e = {m["name"] for m in spec.metrics_for(cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    reader = spec.metric_reader(metric["name"])
    assert callable(reader.read)
    # each cell it lists reports the end-to-end metric it moves
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in spec.metrics_for(cell, "end_to_end")}


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(l) <= 200 and "\n" not in l for l in layers)
    assert {m["better"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} <= {"lower", "higher"}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_limits_files_are_json_with_readings():
    for cell in BENCH["workloads"]:
        data = json.loads((spec.HERE / "limits" / f"{cell['name']}.json").read_text())
        assert set(data["limits"]) <= set(data["readings"]) | {"site_count_gap"}
