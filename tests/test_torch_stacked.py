"""The port's stacked trials (livae_tpu_torch.sweep.stacked) on the CPU at a
small size (patch 32, padding 8, latent 8, batch 4 to 8, 2 steps, float32).

* stack_trees / unstack_tree round trips;
* run_search_stacked against livae_tpu.sweep.run_search_stacked with the same
  fake trainables: the same grouping, trial ids, statuses, errors and
  results.json;
* a 2-lane stacked epoch (different lr, weight decay, beta, gamma and init
  seeds) against two sequential `make_fused_vae_train_step` runs of the port
  from the same weights and generators: epoch metrics at rtol 1e-4, weights
  within 2 lr per step with fewer than 0.1 % of elements beyond 1e-4 (the
  bound of tests/test_torch_engine.py: under vmap the convolutions are
  grouped convolutions, whose sums run in another order); the stacked eval's
  [K, S] rows against `make_fused_eval` at rtol 1e-4;
* the stacked AdamW and per-lane clip against torch.optim.AdamW and
  `_clip_by_global_norm`, lane by lane, within 1e-6 relative;
* the stacked step against livae_tpu's fused VAE step lane by lane (the
  draws and the noise reproduced from JAX's keys, the noise fed to JAX's
  reparameterisation; JAX's vmapped step cannot take injected noise, and
  tests/test_stacked.py holds that step equal to the stack): metrics at rtol
  1e-3, weights within 2 lr per step with fewer than 0.1 % beyond 1e-4, the
  bounds of tests/test_torch_vae.py;
* bench_stacked --cpu --quick prints one JSON line with the JAX script's keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import livae_tpu.models.rvae as jrvae
import livae_tpu.sweep as jsw
import livae_tpu_torch.sweep as tsw
from livae_tpu.data.pipeline import AugmentConfig, _sample_aug, pad_frames
from livae_tpu.models import init_params
from livae_tpu.train import engine as je
from livae_tpu.train.state import TrainState
from livae_tpu_torch.data.pipeline import AugmentConfig as TorchAugmentConfig, PairedDraws
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.scripts import bench_stacked
from livae_tpu_torch.scripts._common import stream_generator
from livae_tpu_torch.sweep import stacked as ts
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils.checkpoint import load_jax_params

PATCH, LATENT, PAD = 32, 8, 8
MARGIN = (PATCH + 2 * PAD + 16) // 2 + 8
LANES = [dict(seed=0, lr=1e-3, wd=1e-5, beta=1.0, gamma=0.5),
         dict(seed=1, lr=3e-4, wd=1e-4, beta=4.0, gamma=2.0)]
OPTS = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, grad_max_norm=20.0,
            use_diversity=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def site_table(rng):
    """Two random frames and 40 sites, in both packages' forms."""
    N, H, W, n = 2, 120, 140, 40
    raw = rng.random((N, H, W)).astype(np.float32)
    coords = np.stack([rng.uniform(20, H - 20, n), rng.uniform(20, W - 20, n)],
                      axis=1).astype(np.float32)
    img_idx = rng.integers(0, N, n).astype(np.int32)
    jtable = (pad_frames(jnp.asarray(raw), MARGIN), jnp.asarray(img_idx), jnp.asarray(coords))
    ttable = (torch.nn.functional.pad(torch.from_numpy(raw), (MARGIN,) * 4),
              torch.from_numpy(img_idx).long(), torch.from_numpy(coords))
    return jtable, ttable


def _model(seed):
    return RVAE(LATENT, 1, PATCH, device="cpu", generator=stream_generator(seed, "init", 0, "cpu"))


def _weight_diffs(state_a: dict, state_b: dict) -> np.ndarray:
    return np.concatenate([np.abs(v.detach().numpy() - state_b[k].detach().numpy()).ravel()
                           for k, v in state_a.items()])


def test_stack_unstack_roundtrip():
    trees = [{"a": torch.full((3,), float(i)), "b": [torch.full((2, 2), float(-i))]}
             for i in range(4)]
    stacked = ts.stack_trees(trees)
    assert stacked["a"].shape == (4, 3) and stacked["b"][0].shape == (4, 2, 2)
    back = ts.unstack_tree(stacked, 4)
    for t0, t1 in zip(trees, back):
        assert torch.equal(t0["a"], t1["a"]) and torch.equal(t0["b"][0], t1["b"][0])
    models = [_model(0), _model(1)]
    state = ts.StackedState.create(models)
    for i, m in enumerate(models):
        assert all(torch.equal(v, state.lane_state_dict(i)[k]) for k, v in m.state_dict().items())
    lanes = ts.unstack_tree(ts.stack_trees([m.state_dict() for m in models]), 2)
    assert all(torch.equal(lanes[1][k], v) for k, v in models[1].state_dict().items())


def _search(sw, tmp_path, trainable, **kw):
    trials = sw.run_search_stacked(trainable, {"lr": sw.loguniform(1e-5, 1e-2),
                                               "latent_dim": sw.choice([4, 8])},
                                   results_dir=tmp_path, seed=0, **kw)
    return trials, json.loads((tmp_path / "results.json").read_text())


@pytest.mark.parametrize("search_alg", ["random", "tpe"])
def test_run_search_stacked_equals_jax(tmp_path, search_alg):
    """Grouping, trial ids, statuses, errors and results.json as the JAX
    engine's, with a stack of latent_dim 4 failing."""
    calls = {"jax": [], "port": []}

    def trainable(name):
        def run(configs, report):
            calls[name].append([c["latent_dim"] for c in configs])
            assert len({c["latent_dim"] for c in configs}) == 1
            if configs[0]["latent_dim"] == 4 and len(calls[name]) > 2:
                raise RuntimeError("boom")
            for lane, cfg in enumerate(configs):
                for epoch in (1, 2):
                    report(lane, epoch, loss=cfg["lr"] * epoch, val_loss=cfg["lr"],
                           checkpoint=f"trial_{cfg['lr']:.6f}.pt")
        return run

    kw = dict(num_samples=9, stack_size=4, search_alg=search_alg)
    jt, jr = _search(jsw, tmp_path / "jax", trainable("jax"), **kw)
    tt, tr = _search(tsw, tmp_path / "port", trainable("port"), **kw)
    assert calls["port"] == calls["jax"] and len(calls["port"]) > 2
    assert [(t.trial_id, t.config, t.status, t.error) for t in tt] == \
        [(t.trial_id, t.config, t.status, t.error) for t in jt]
    assert tr == jr
    assert {t.status for t in tt} == {"done", "error"}


def _sequential(lane, table, idx, cfg):
    model = _model(lane["seed"])
    opt = make_optimizer(model, lane["lr"], optimizer="adamw", weight_decay=lane["wd"])
    step = te.make_fused_vae_train_step(model, opt, cfg=cfg, device="cpu", **OPTS)
    gen = stream_generator(lane["seed"], "train", 0, "cpu")
    metrics = te.metrics_to_host(step(*table, idx, gen, lane["beta"], lane["gamma"]))
    return model, metrics


def _stacked(table, idx, cfg, generators, **kw):
    models = [_model(lane["seed"]) for lane in LANES]
    step, evaluate = ts.make_stacked_fns(models[0], cfg=cfg, device="cpu", **OPTS)
    state = ts.set_stacked_hyperparams(ts.StackedState.create(models),
                                       [lane["lr"] for lane in LANES],
                                       [lane["wd"] for lane in LANES])
    state, metrics = step(state, *table, torch.stack([idx] * len(LANES)), generators,
                          [lane["beta"] for lane in LANES], [lane["gamma"] for lane in LANES],
                          **kw)
    return state, te.metrics_to_host(metrics), evaluate


def test_stacked_epoch_equals_sequential_trials(site_table, rng):
    """Two lanes, one stacked epoch of 2 steps (batch 8), against the two
    sequential trials; then the stacked eval against make_fused_eval."""
    _, table = site_table
    cfg = TorchAugmentConfig()
    idx = torch.from_numpy(rng.permutation(40)[:16].reshape(2, 8)).long()
    gens = [stream_generator(lane["seed"], "train", 0, "cpu") for lane in LANES]
    state, got, evaluate = _stacked(table, idx, cfg, gens)
    val = torch.from_numpy(rng.permutation(40)[:12].reshape(3, 4)).long()
    val_gens = [stream_generator(lane["seed"], "val", 0, "cpu") for lane in LANES]
    betas, gammas = [1.0, 4.0], [0.5, 2.0]
    rows = te.metrics_to_host(evaluate(state.params, *table, torch.stack([val] * len(LANES)),
                                       val_gens, betas, gammas))
    for k, lane in enumerate(LANES):
        model, want = _sequential(lane, table, idx, cfg)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name][k], want[name], rtol=1e-4, atol=1e-7,
                                       err_msg=f"lane {k} {name}")
        diffs = _weight_diffs(state.lane_state_dict(k), model.state_dict())
        assert diffs.max() <= 2 * lane["lr"] * 2
        assert np.mean(diffs > 1e-4) < 1e-3

        # the eval: lane k's rows against the sequential eval of its weights
        model.load_state_dict(state.lane_state_dict(k))
        seq_eval = te.make_fused_eval(model, patch_size=PATCH, padding=PAD, margin=MARGIN,
                                      use_diversity=True, device="cpu")
        want_rows = te.metrics_to_host(seq_eval(
            *table, val, stream_generator(lane["seed"], "val", 0, "cpu"), betas[k], gammas[k]))
        assert set(rows) == set(want_rows)
        for name, v in want_rows.items():
            assert rows[name].shape == (2, 3)
            np.testing.assert_allclose(rows[name][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"eval lane {k} {name}")


def test_stacked_adamw_and_clip_equal_torch_per_lane(rng):
    """Three steps of `_clip_lanes` + `_adamw_lanes` on 3 lanes with their own
    lr and weight decay against torch.optim.AdamW and `_clip_by_global_norm`
    on each lane alone (the first lane clipped, the others not), within 1e-6
    relative."""
    K, max_norm = 3, 5.0
    shapes = {"w": (4, 5), "b": (5,), "c": (2, 3, 3)}
    lrs, wds = [1e-3, 3e-2, 5e-4], [1e-5, 1e-2, 0.0]
    init = {n: rng.standard_normal((K, *s)).astype(np.float32) for n, s in shapes.items()}
    state = ts.StackedState(
        params={n: torch.from_numpy(v.copy()).requires_grad_(True) for n, v in init.items()},
        exp_avg={n: torch.zeros((K, *s)) for n, s in shapes.items()},
        exp_avg_sq={n: torch.zeros((K, *s)) for n, s in shapes.items()},
        learning_rate=torch.zeros(K), weight_decay=torch.zeros(K))
    ts.set_stacked_hyperparams(state, lrs, wds)
    lanes = []
    for k in range(K):
        params = [torch.from_numpy(init[n][k].copy()).requires_grad_(True) for n in shapes]
        opt = torch.optim.AdamW(params, lr=lrs[k], weight_decay=wds[k], betas=(0.9, 0.999),
                                eps=1e-8)
        lanes.append((params, opt))
    for _ in range(3):
        lane_scale = {n: np.array([3.0, 0.01, 0.02]).reshape(-1, *[1] * len(s))
                      for n, s in shapes.items()}
        grads = {n: (rng.standard_normal((K, *s)) * lane_scale[n]).astype(np.float32)
                 for n, s in shapes.items()}
        for n, p in state.params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        gnorm = ts._clip_lanes([p.grad for p in state.params.values()], max_norm)
        ts._adamw_lanes(state)
        for k, (params, opt) in enumerate(lanes):
            for n, p in zip(shapes, params):
                p.grad = torch.from_numpy(grads[n][k].copy())
            want_norm = te._clip_by_global_norm([p.grad for p in params], max_norm)
            opt.step()
            torch.testing.assert_close(gnorm[k], want_norm, rtol=1e-6, atol=0)
            for n, p in zip(shapes, params):
                torch.testing.assert_close(state.params[n][k].detach(), p.detach(), rtol=1e-6,
                                           atol=1e-7)
    assert gnorm[0] == max_norm and gnorm[1] < max_norm


@pytest.fixture
def eps_queue(monkeypatch):
    """Host-fed noise for JAX's rVAE (one pop per call)."""
    queue = []

    def reparameterize(key, mu, logvar):
        eps = jax.pure_callback(lambda _: queue.pop(0), jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                                jax.lax.stop_gradient(mu))
        return mu + eps * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    return queue


def test_stacked_step_equals_jax_lane_by_lane(site_table, rng, eps_queue):
    jtable, ttable = site_table
    B, S = 8, 2
    idx = rng.permutation(40)[: S * B].reshape(S, B).astype(np.int32)
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3, weight_decay=1e-5)
    jstep = je.make_fused_vae_train_step(jmodel, tx, cfg=AugmentConfig(), **OPTS)
    models, draws, eps, want = [], [], [], []
    for k, lane in enumerate(LANES):
        params = init_params(jmodel, {"params": jax.random.key(10 + k),
                                      "sample": jax.random.key(20 + k)},
                             jnp.zeros((1, PATCH, PATCH, 1)))
        model = RVAE(LATENT, 1, PATCH, device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
        models.append(model)
        key = jax.random.key(30 + k)
        lane_draws = []
        for i in range(S):
            ke, _ = jax.random.split(jax.random.fold_in(key, i))
            v = [np.array(a) for a in _sample_aug(ke, B, AugmentConfig())]
            t = torch.from_numpy
            scale, angle, fh, fv, jy, jx = v
            lane_draws.append(PairedDraws(t(scale), t(fh), t(fv), t(jy).long(), t(jx).long(),
                                          t(angle)))
        draws.append(lane_draws)
        lane_eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(S)]
        eps.append([torch.from_numpy(e) for e in lane_eps])
        eps_queue.extend(lane_eps)
        state = TrainState.create(jax.tree_util.tree_map(jnp.array, params), tx)
        hp = dict(state.opt_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lane["lr"], jnp.float32)
        hp["weight_decay"] = jnp.asarray(lane["wd"], jnp.float32)
        state = state.replace(opt_state=state.opt_state._replace(hyperparams=hp))
        state, m = jstep(state, *jtable, jnp.asarray(idx), key, lane["beta"], lane["gamma"])
        assert not eps_queue
        want.append((state.params, je.metrics_to_host(m)))

    step, _ = ts.make_stacked_fns(models[0], cfg=TorchAugmentConfig(), device="cpu", **OPTS)
    state = ts.set_stacked_hyperparams(ts.StackedState.create(models),
                                       [lane["lr"] for lane in LANES],
                                       [lane["wd"] for lane in LANES])
    state, got = step(state, *ttable, torch.from_numpy(np.stack([idx] * 2)).long(), None,
                      [lane["beta"] for lane in LANES], [lane["gamma"] for lane in LANES],
                      draws=draws, eps=eps)
    got = te.metrics_to_host(got)
    for k, (jparams, jm) in enumerate(want):
        assert set(got) == set(jm)
        for name in jm:
            np.testing.assert_allclose(got[name][k], jm[name], rtol=1e-3, atol=2e-4,
                                       err_msg=f"lane {k} {name}")
        ref = RVAE(LATENT, 1, PATCH, device="cpu")
        load_jax_params(ref, jax.tree_util.tree_map(np.asarray, jparams))
        diffs = _weight_diffs(state.lane_state_dict(k), ref.state_dict())
        assert diffs.max() <= 2 * LANES[k]["lr"] * S
        assert np.mean(diffs > 1e-4) < 1e-3


JAX_BENCH_KEYS = ["trials", "epochs", "patch_size", "batch_size", "steps_per_epoch",
                  "sequential_s", "stacked_s", "speedup", "seq_patches_per_sec",
                  "stacked_patches_per_sec", "backend"]  # scripts/bench_stacked.py's line


def test_bench_stacked_quick_prints_the_jax_keys(capsys):
    result = bench_stacked.main(["--cpu", "--quick"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result)[: len(JAX_BENCH_KEYS)] == JAX_BENCH_KEYS
    assert result["backend"] == "cpu" and result["trials"] == 2 and result["epochs"] == 2
    assert result["sequential_s"] > 0 and result["stacked_s"] > 0
    assert result["stacked_launches_per_epoch"]["rot3_fwd"] == 0  # the CPU launches no kernel
