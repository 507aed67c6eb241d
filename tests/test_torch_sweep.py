"""The port's sweep engine (livae_tpu_torch.sweep) against livae_tpu.sweep on
the same toy trainables and seeds, driven as tests/test_sweep.py drives the
JAX engine: the configs in order, the ASHA stops, the PBT exploits and their
payloads, the TPE suggestions, results.json and get_best_result must be the
same (the toys report no wall-clock figures, so results.json is compared
whole). Also: the thread and process executors, and the kernels' launch
counters under threads.
"""

import json
import sys
import threading

import numpy as np
import pytest

import _sweep_toy as toy
import livae_tpu.sweep as jsw
import livae_tpu.sweep.search as jss
import livae_tpu_torch.sweep as tsw
import livae_tpu_torch.sweep.search as tss
from livae_tpu_torch import tracing

ENGINES = {"jax": (jsw, jss), "port": (tsw, tss)}


def _space(mod, epochs=9):
    return {"x": mod.uniform(0.0, 6.0), "lr": mod.loguniform(1e-3, 0.5),
            "k": mod.choice([1, 2, 3]), "epochs": epochs}


def _run(name, tmp_path, trainable, scheduler=None, **kw):
    """(trials, results.json) of one engine."""
    sw, _ = ENGINES[name]
    out = tmp_path / name
    sched = scheduler(sw) if scheduler else None
    trials = sw.run_search(trainable, _space(sw, kw.pop("epochs", 9)), scheduler=sched,
                           results_dir=out, **kw)
    return trials, json.loads((out / "results.json").read_text())


def _both(tmp_path, trainable, **kw):
    (jt, jr), (tt, tr) = (_run(n, tmp_path, trainable, **kw) for n in ("jax", "port"))
    assert [t.config for t in tt] == [t.config for t in jt]
    assert [t.status for t in tt] == [t.status for t in jt]
    assert tr == jr
    for metric, mode in (("loss", "min"), ("val_loss", "min"), ("loss", "max")):
        jb = jsw.get_best_result(jt, metric, mode)
        tb = tsw.get_best_result(tt, metric, mode)
        assert (tb is None) == (jb is None)
        if jb is not None:
            assert (tb.trial_id, tb.config) == (jb.trial_id, jb.config)
    return tt, tr


def test_exports_match_jax_without_the_stacked_names():
    """The port exports what livae_tpu.sweep exports, the five stacked names
    included, and sweep.search / sweep.stacked have the JAX modules' __all__."""
    import livae_tpu.sweep.stacked as jst
    import livae_tpu_torch.sweep.stacked as tst

    stacked = {"make_stacked_fns", "run_search_stacked", "set_stacked_hyperparams",
               "stack_trees", "unstack_tree"}
    jax_names = {n for n in dir(jsw) if not n.startswith("_")} - {"search", "stacked"}
    assert stacked <= jax_names and set(tsw.__all__) == jax_names
    assert set(tss.__all__) == set(jss.__all__)
    assert tst.__all__ == jst.__all__ and tst.STRUCTURAL_KEYS == jst.STRUCTURAL_KEYS


@pytest.mark.parametrize("search_alg", ["random", "tpe", "hyperopt"])
def test_asha_stops_equal_jax(tmp_path, search_alg):
    trials, results = _both(
        tmp_path, toy.quadratic, num_samples=12, search_alg=search_alg, seed=3,
        scheduler=lambda sw: sw.ASHAScheduler(metric="loss", mode="min", max_t=9,
                                              grace_period=1, reduction_factor=3))
    statuses = {t.status for t in trials}
    assert statuses == {"done", "stopped"}, statuses
    assert [r["epochs"] for r in results] == [len(t.history) for t in trials]


def test_pbt_exploits_equal_jax(tmp_path):
    trials, _ = _both(
        tmp_path, toy.population, num_samples=8, search_alg="random", seed=1, epochs=6,
        scheduler=lambda sw: sw.PBTScheduler(
            metric="loss", mode="min", perturbation_interval=2, quantile_fraction=0.5,
            hyperparam_mutations={"lr": sw.loguniform(1e-3, 0.5)}))
    exploited = [t for t in trials if any(m["source"] for m in t.history)]
    assert exploited, "no trial exploited a donor"
    # the payload the trial took: a donor's checkpoint and a mutated config
    for t in exploited:
        assert any(m["source"].startswith("x=") for m in t.history)


def test_trial_errors_and_get_best_result_equal_jax(tmp_path):
    trials, results = _both(tmp_path, toy.failing, num_samples=8, search_alg="random", seed=0)
    assert {t.status for t in trials} == {"done", "error"}
    assert all(r["error"] == "RuntimeError: toy failure" for r in results
               if r["status"] == "error")
    assert tsw.get_best_result([], "loss") is None


def test_tpe_suggestions_equal_jax():
    rng = np.random.default_rng(4)
    observations = [({"x": float(x), "lr": float(lr), "k": int(k), "epochs": 3},
                     float((x - 3) ** 2 + k))
                    for x, lr, k in zip(rng.uniform(0, 6, 14), rng.uniform(1e-3, 0.5, 14),
                                        rng.integers(1, 4, 14))]
    for mode in ("min", "max"):
        j = jss.TPESearcher(_space(jss), mode=mode, seed=7)
        t = tss.TPESearcher(_space(tss), mode=mode, seed=7)
        for n in (0, 3, 8, 11, 14):
            assert t.suggest(observations[:n]) == j.suggest(observations[:n])


def test_thread_executor_equals_jax(tmp_path):
    """Three worker threads, random search, no scheduler: every trial's
    config and history are set by its id, whatever the interleaving."""
    trials, _ = _both(tmp_path, toy.quadratic, num_samples=6, search_alg="random", seed=2,
                      max_concurrent=3, executor="thread", epochs=3)
    assert all(t.status == "done" for t in trials)


def test_process_executor_pins_each_slot(tmp_path, monkeypatch):
    """Two spawned slots, each with its slot's CUDA_VISIBLE_DEVICES from
    train_rvae_raytune.default_trial_env; the results equal a sequential
    run's, but for the process fields."""
    from livae_tpu_torch.scripts.train_rvae_raytune import default_trial_env

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    space = {"x": tsw.uniform(0.0, 1.0)}
    env = lambda slot: default_trial_env(slot, num_devices=2)  # noqa: E731
    trials = tsw.run_search(toy.in_process, space, num_samples=3, results_dir=tmp_path / "p",
                            max_concurrent=2, executor="process", trial_env=env)
    seq = tsw.run_search(toy.in_process, space, num_samples=3, results_dir=tmp_path / "s")
    assert [t.status for t in trials] == ["done"] * 3
    assert [t.config for t in trials] == [t.config for t in seq]
    assert [t.last("loss") for t in trials] == [t.last("loss") for t in seq]
    assert len({t.last("pid") for t in trials}) >= 2
    assert {t.last("cuda_visible") for t in trials} == {"0", "1"}
    assert [t.last("trial_env_id") for t in trials] == ["0", "1", "2"]
    assert "CUDA_VISIBLE_DEVICES" not in __import__("os").environ


def test_default_trial_env():
    from livae_tpu_torch.scripts.train_rvae_raytune import default_trial_env

    assert default_trial_env(3, num_devices=2) == {"LIVAE_SWEEP_SLOT": "3",
                                                   "CUDA_VISIBLE_DEVICES": "1"}
    assert default_trial_env(0, force_platform="cpu") == {"LIVAE_SWEEP_SLOT": "0",
                                                          "LIVAE_FORCE_PLATFORM": "cpu"}


@pytest.mark.parametrize("counter", ["rot3", "shear"])
def test_launch_counters_are_exact_under_threads(counter):
    """Sixteen threads add to a kernel's launch counters in the registry
    (`livae_tpu_torch.tracing`) at once, with the interpreter switching
    threads every microsecond: no count is lost."""
    per_thread, n_threads = 2000, 16
    fwd, bwd = f"{counter}_fwd", f"{counter}_bwd"
    before = tracing.counters()
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for i in range(per_thread):
            tracing.count(fwd if i % 2 else bwd)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = tracing.counters()
    assert (after[fwd] - before.get(fwd, 0) == after[bwd] - before.get(bwd, 0)
            == n_threads * per_thread // 2)
