"""The port's comparison harnesses on the CPU at a small size, against the JAX
scripts (scripts/compare_vae_rvae.py, compare_resample_elbo.py,
accuracy_program.py):

* compare_vae_rvae: the parameter counts equal the JAX script's
  `count_params` of the JAX models; a run prints PASS and returns its figures;
* compare_resample_elbo: the full objective of the fast and of the exact
  resampler on the same weights (carried across by the weight bridge), the
  same batches and the same noise, against the JAX script's `full_objective`,
  at 2e-4 (the model parity bound); the gate read from BASELINE.json; a short
  run's JSON keys are the JAX script's;
* accuracy_program: `site_truth_labels` equal, `latent_metrics` within 1e-9
  (the same sklearn calls on the same float64 means), `sweep_row_rank` and
  `summarize_seeds` equal, `rot90_cosine` at 2e-4, and a --quick run;
* every new entry point raises without CUDA unless asked for the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
import livae_tpu.models.vae as jvae
from livae_tpu.models import init_params
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.scripts import accuracy_program, compare_resample_elbo, compare_vae_rvae
from livae_tpu_torch.utils.checkpoint import load_jax_params

REPO = Path(__file__).resolve().parent.parent
PATCH, LATENT = 32, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX scripts' modules (scripts/ on the path, as they run)."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import accuracy_program as jacc
    import compare_resample_elbo as jelbo
    import compare_vae_rvae as jcmp

    return jcmp, jelbo, jacc


def _jax_params(model, patch, key=0):
    return init_params(model, {"params": jax.random.key(key), "sample": jax.random.key(key + 1)},
                       jnp.zeros((1, patch, patch, 1)))


def test_compare_vae_rvae_counts_equal_jax(jax_scripts, capsys):
    jcmp, _, _ = jax_scripts
    out = compare_vae_rvae.main(["--cpu", "--batch-size", "4", "--iters", "1"])
    printed = capsys.readouterr().out
    want_v = jcmp.count_params(_jax_params(jvae.VAE(latent_dim=16, patch_size=64), 64))
    want_r = jcmp.count_params(_jax_params(jrvae.RVAE(latent_dim=16, patch_size=64), 64))
    assert (out["vae_params"], out["rvae_params"]) == (want_v, want_r)
    assert out["ok"] and printed.rstrip().endswith("PASS")
    assert f"VAE : {want_v / 1e6:.2f}M params" in printed
    assert out["vae_imgs_per_s"] > 0 and out["rvae_imgs_per_s"] > 0


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


def test_full_objective_equals_jax(jax_scripts, eps_queue, rng):
    """The fast and exact objectives on two batches of 4: each against the JAX
    script's at 2e-4, with the same weights and noise."""
    _, jelbo, _ = jax_scripts
    params = _jax_params(jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH), PATCH)
    batches_np = [(rng.random((4, PATCH, PATCH, 1)).astype(np.float32),
                   rng.random((4, PATCH, PATCH, 1)).astype(np.float32),
                   rng.uniform(0, 2 * np.pi, 4).astype(np.float32)) for _ in range(2)]
    eps = [rng.standard_normal((4, LATENT)).astype(np.float32) for _ in range(2)]

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    batches = [(nchw(x), nchw(xr), torch.from_numpy(a)) for x, xr, a in batches_np]
    for fast in (True, False):
        jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH, fast_resample=fast)
        eps_queue.extend(eps)
        want = jelbo.full_objective(jmodel, params,
                                    [tuple(jnp.asarray(v) for v in b) for b in batches_np],
                                    10.0, 10.0, 0.2, jax.random.key(0))
        assert not eps_queue
        model = RVAE(LATENT, 1, PATCH, fast_resample=fast, device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
        got = compare_resample_elbo.full_objective(model, batches, 10.0, 10.0, 0.2,
                                                   [torch.from_numpy(e) for e in eps])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=f"fast={fast}")


def test_compare_resample_elbo_short_run(jax_scripts, capsys):
    """A short run: the JAX script's keys, the gate of BASELINE.json, finite
    objectives, and the dual training."""
    assert compare_resample_elbo.elbo_gate() == 0.01
    args = compare_resample_elbo.build_argparser().parse_args(
        ["--cpu", "--synthetic", "1", "--synthetic-size", "512", "--patch-size", str(PATCH),
         "--padding", "8", "--batch-size", "16", "--latent-dim", str(LATENT),
         "--train-epochs", "1", "--eval-batches", "2", "--dual-train"])
    out = compare_resample_elbo.main(args)
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == out
    assert list(out) == ["fast_objective", "exact_objective", "relative_delta", "gate",
                         "passes_1pct_gate", "batches", "batch_size", "beta", "gamma",
                         "dual_train"]
    assert out["gate"] == 0.01 and out["batches"] == 2 and out["batch_size"] == 16
    assert np.isfinite(out["fast_objective"]) and np.isfinite(out["exact_objective"])
    assert out["passes_1pct_gate"] == (out["relative_delta"] < 0.01)
    assert set(out["dual_train"]) == {"fast_final_loss", "exact_final_loss", "relative_delta"}
    jax_parser = jax_scripts[1].build_argparser()
    ours = compare_resample_elbo.build_argparser()
    assert vars(ours.parse_args([])) == vars(jax_parser.parse_args([]))


def test_accuracy_helpers_equal_jax(jax_scripts, rng):
    _, _, jacc = jax_scripts
    frame, truth = synthetic_mos2_frame(size=256, spacing=40.0, vacancy_rate=0.12,
                                        s_amplitude=0.45, seed=3)
    sites = rng.uniform(0, 256, (200, 2))
    sites[:60] = np.asarray(truth["mo_sites"])[:60] + rng.normal(0, 2, (60, 2))
    got, want = accuracy_program.site_truth_labels(sites, truth), jacc.site_truth_labels(sites,
                                                                                          truth)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

    labels = rng.integers(0, 3, 90)
    mu = rng.standard_normal((90, 4)) + labels[:, None]
    logvar = rng.standard_normal((90, 4)) * 0.1
    got, want = accuracy_program.latent_metrics(mu, logvar, labels), jacc.latent_metrics(
        mu, logvar, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)

    rows = [{"status": "stopped", "val_loss": 0.1}, {"val_loss": 0.3}, {"status": "done"},
            {"status": "done", "val_loss": 0.2}, {"val_loss": None}]
    assert sorted(rows, key=accuracy_program.sweep_row_rank) == sorted(rows,
                                                                      key=jacc.sweep_row_rank)
    results = [{"config": {"beta": b, "normalize": n, "lr": 1e-3, "latent_dim": 8, "gamma": 1.0},
                "seed": s, **{k: float(rng.random()) for k in accuracy_program._SUMMARY_KEYS}}
               for b in (0.1, 1.0) for n in (True, False) for s in (0, 1000)]
    assert accuracy_program.summarize_seeds(results) == jacc.summarize_seeds(results)


def test_rot90_cosine_equals_jax(jax_scripts, rng):
    _, _, jacc = jax_scripts
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = _jax_params(jmodel, PATCH)
    model = RVAE(LATENT, 1, PATCH, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    x = rng.random((6, PATCH, PATCH, 1)).astype(np.float32)
    want = jacc.rot90_cosine(jmodel, params, jnp.asarray(x))
    got = accuracy_program.rot90_cosine(model, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_accuracy_program_quick(tmp_path, capsys):
    out = tmp_path / "acc.json"
    results = accuracy_program.main(accuracy_program.parse_args(
        ["--quick", "--cpu", "--out", str(out), "--seeds", "2", "--no-norm-ablation"]))
    printed = capsys.readouterr().out
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert [r["seed"] for r in results] == [0, 1000]
    for r in results:
        assert r["config"]["epochs"] == 2 and r["eval_sites"] > 0
        assert all(np.isfinite(r[k]) for k in ("kld_mean", "rot90_mu_cosine", "kmeans_ari",
                                                "train_loss"))
    summary = json.loads((tmp_path / "acc.json.summary.json").read_text())
    assert len(summary) == 1 and summary[0]["n_seeds"] == 2
    assert "mean ± std across seeds" in printed


def test_accuracy_program_says_what_it_skips_without_sklearn(tmp_path, monkeypatch, capsys):
    """Without sklearn (the card's machine) the run trains, encodes and names
    the metrics it skipped."""
    monkeypatch.setattr(accuracy_program, "sklearn_available", lambda: False)
    args = accuracy_program.parse_args(["--quick", "--cpu", "--out", str(tmp_path / "a.json"),
                                        "--no-norm-ablation", "--epochs", "1"])
    (row,) = accuracy_program.main(args)
    printed = capsys.readouterr().out
    assert "skipped kmeans_ari, linear_accuracy, vacancy_auc" in printed
    assert np.isnan(row["kmeans_ari"]) and np.isfinite(row["kld_mean"])
    assert np.isfinite(row["rot90_mu_cosine"])


@pytest.mark.parametrize("entry", ["bench_stacked", "compare_vae_rvae", "compare_resample_elbo",
                                   "accuracy_program"])
def test_new_entry_points_raise_without_cuda(monkeypatch, entry):
    from livae_tpu_torch.scripts import bench_stacked

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {
        "bench_stacked": lambda: bench_stacked.main(["--quick"]),
        "compare_vae_rvae": lambda: compare_vae_rvae.main([]),
        "compare_resample_elbo": lambda: compare_resample_elbo.main(
            compare_resample_elbo.build_argparser().parse_args(["--synthetic", "1"])),
        "accuracy_program": lambda: accuracy_program.main(accuracy_program.parse_args([])),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
