"""The traffic loops at a tiny size on the CPU, the reference against the
port, and the planted faults that must turn `correct` false.

The sizes are cut (one 512-pixel frame, patch 32, batch 16) and the port
and the reference compute in float32, where they agree to rounding; the
limits are the cells' own."""

import json

import pytest
import torch

from portbench import harness, spec, trace

CPU = torch.device("cpu")
TINY = {"config": {"patch_size": 32, "padding": 8, "latent_dim": 8},
        "traffic": {"frames": 1, "frame_size": 512, "batch_size": 16, "trace_steps": 2,
                    "trace_passes": 1}}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 977


def tiny(cell: str, f32: bool = True) -> dict:
    over = {"config": dict(TINY["config"]), "traffic": TINY["traffic"]}
    if f32:
        precision = dict(spec.config(spec.workload(cell)["config"])["precision"])
        precision["compute_dtype"] = None
        precision["reference"] = {"conv": "float32", "io": "float32"}
        over["config"]["precision"] = precision
    return over


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_run_line(cell, traced):
    out = harness.run_cell(cell, SEED, 0.5, traced, CPU, 0.0, tiny(cell))
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    if traced:
        assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device here: the device's readers find nothing
        assert "mfu.train" not in out["metrics"] and "mfu.encode" not in out["metrics"]
        assert out["metrics"]["setup.dataset_build_s"]["value"] > 0
    else:
        want = {m["name"] for m in spec.metrics_for(cell, "end_to_end")}
        assert set(out["metrics"]) == want


def _evidence(cell: str, over: dict):
    w = spec.workload(cell)
    cfg = {**spec.config(w["config"]), **over["config"]}
    traffic = {**spec.traffic(w["traffic"]), **over["traffic"]}
    loop = spec.loop(traffic["loop"])
    run = loop.Run(cfg, traffic, SEED, CPU, trace.Spans())
    run.setup()
    return loop, cfg, traffic, run.close()


@pytest.mark.parametrize("cell", ["rvae128.train", "vae128.train"])
def test_training_reference_follows_the_port(cell):
    loop, cfg, traffic, ev = _evidence(cell, tiny(cell))
    sides = loop.compare(ev, cfg, traffic, CPU, ("program", "control", "half_batch"))
    prog = sides["program"]
    assert prog["site_count_gap"] == 0
    assert prog["loss_gap_step1"] < 1e-5 and prog["terms_gap_step1"] < 1e-4
    assert prog["grad_diff_median"] < 1e-4 and prog["change_gap"] < 1e-2
    # the planted fault reads far above the float32 port
    assert sides["half_batch"]["loss_gap_step1"] > 30 * prog["loss_gap_step1"]


def test_analysis_reference_follows_the_port():
    loop, cfg, traffic, ev = _evidence("rvae128.analyze", tiny("rvae128.analyze", f32=False))
    r = loop.compare(ev, cfg, traffic, CPU, ("program", "control"))
    assert r["program"]["site_count_gap"] == 0
    assert r["program"]["err_gap_max"] < 1e-5 and r["program"]["mu_gap_max"] < 1e-4
    assert r["control"]["err_gap_q99"] > 10 * max(r["program"]["err_gap_q99"], 1e-7)
    assert r["control"]["mu_gap_cond_q99"] > 10 * r["program"]["mu_gap_cond_q99"]


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer's step does nothing."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Half of every batch left out: the rest's mean is the step's loss."""
    from livae_tpu_torch.data.pipeline import PairedDraws
    from livae_tpu_torch.train import engine

    draws = engine._global_draws

    def halved(B, *args, **kw):
        d, e = draws(B, *args, **kw)
        h = B // 2
        d = PairedDraws(**{k: v[:h] for k, v in vars(d).items()}) if d is not None else d
        return d, (e[:h] if e is not None else e)

    monkeypatch.setattr(engine, "_global_draws", halved)
    monkeypatch.setattr(engine, "shard_batch", lambda t, mesh: t[: len(t) // 2])


def _altered_answer(monkeypatch):
    """One site's answer altered where it is produced."""
    from livae_tpu_torch.scripts import visualizations

    stats = visualizations._batch_stats

    def altered(*args, **kw):
        mu, logvar, err = stats(*args, **kw)
        err = err.clone()
        err[0] *= 1.001
        return mu, logvar, err

    monkeypatch.setattr(visualizations, "_batch_stats", altered)


def _altered_latent(monkeypatch):
    """One site in ten given its neighbour's mu where the answers are produced."""
    from livae_tpu_torch.scripts import visualizations

    stats = visualizations._batch_stats

    def altered(*args, **kw):
        mu, logvar, err = stats(*args, **kw)
        mu = mu.clone()
        mu[:-1:10] = mu[1::10]
        return mu, logvar, err

    monkeypatch.setattr(visualizations, "_batch_stats", altered)


@pytest.mark.parametrize("cell,fault", [
    ("rvae128.train", _unchanged), ("vae128.train", _unchanged),
    ("rvae128.train", _half_batch), ("vae128.train", _half_batch),
    ("rvae128.analyze", _altered_answer), ("rvae128.analyze", _altered_latent),
], ids=lambda v: getattr(v, "__name__", v))
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run_cell(cell, SEED, 0.3, False, CPU, 0.0, tiny(cell))
    assert out["correct"] is False


def _side_on_the_card(cell: str, side: str) -> dict:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    loop = spec.loop(traffic["loop"])
    run = loop.Run(cfg, traffic, SEED, dev, trace.Spans())
    run.setup()
    return loop.compare(run.close(), cfg, traffic, dev, (side,))[side]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    """The control (the reference at the precision below the configuration's,
    in the program's place) fails the cell's limits at the cell's own size."""
    assert harness.judge(_side_on_the_card(cell, "control"), spec.limits(cell))[0] is False


@pytest.mark.card
@pytest.mark.parametrize("cell,side", [("rvae128.train", "half_batch"),
                                       ("vae128.train", "half_batch"),
                                       ("rvae128.analyze", "altered")])
def test_fault_is_not_correct_on_the_card(cell, side):
    """A planted fault (half of each batch left out; one site in a hundred
    given its neighbour's mu) fails the cell's limits at the cell's own size."""
    assert harness.judge(_side_on_the_card(cell, side), spec.limits(cell))[0] is False
