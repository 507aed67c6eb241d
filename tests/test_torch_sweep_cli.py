"""The port's sweep CLIs on the CPU at a small size (one 512-pixel synthetic
frame, patch 32, padding 8, batch 64, latent 8, 2 epochs, f32):
train_rvae_raytune (thread and process executors, ASHA, the PBT exploit of
`_trial_body`, --stacked), train_rvae_with_best, analyze_raytune_results,
compare_training_methods and test_raytune_deps, against the JAX scripts where
they write something comparable; --stacked against a sequential run of the
same trials."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from livae_tpu_torch.data.datasets import AdaptiveLatticeDataset, default_transform
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.scripts import (
    analyze_raytune_results,
    compare_training_methods,
    train_rvae,
    train_rvae_raytune,
    train_rvae_with_best,
)
from livae_tpu_torch.scripts import test_raytune_deps as raytune_deps
from livae_tpu_torch.utils.checkpoint import load_reference_checkpoint, save_reference_checkpoint

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--cpu", "--synthetic", "1", "--synthetic-size", "512", "--patch-size", "32",
         "--padding", "8", "--batch-sizes", "64", "--latent-dims", "8", "--epochs", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(root: Path, name: str, *extra):
    return [*SMALL, "--ray-results-dir", str(root / "ray_results"), "--experiment-name", name,
            "--save-best-config", str(root / name / "best_config.json"), *extra]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Two trials on two threads under ASHA and the native TPE (the defaults)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("sweep")
    args = train_rvae_raytune.build_argparser().parse_args(
        _argv(root, "cli", "--num-samples", "2", "--max-concurrent", "2"))
    out = train_rvae_raytune.run_hyperparameter_search(args)
    return root, out


def _surface(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                      getattr(a.type, "__name__", None), a.const, a.choices)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_has_the_jax_parsers_options_and_defaults(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import train_rvae_raytune as jax_script

    ours, theirs = train_rvae_raytune.build_argparser(), jax_script.build_argparser()
    assert _surface(ours) == _surface(theirs)
    assert vars(ours.parse_args([])) == vars(theirs.parse_args([]))


def test_sweep_writes_results_and_best_config(sweep):
    root, out = sweep
    results = json.loads((root / "ray_results" / "cli" / "results.json").read_text())
    # ASHA's one rung (grace 1 of 2 epochs) keeps the first trial to report
    # there and stops the second if it is worse: which one is the threads' race
    statuses = sorted(t["status"] for t in results)
    assert len(results) == 2 and statuses in (["done", "done"], ["done", "stopped"])
    for t in results:
        assert t["epochs"] == (2 if t["status"] == "done" else 1)
        assert t["checkpoint"].endswith(f"trial_{t['trial_id']}.pt")
        for m in t["history"]:
            assert np.isfinite(m["loss"]) and np.isfinite(m["train_loss"])
            assert m["steps"] >= 1 and m["val_batches"] >= 1 and m["train_patches_per_s"] > 0
            assert m["rot3_fwd"] == m["rot3_bwd"] == 0  # no kernel on the CPU
        state, payload = load_reference_checkpoint(t["checkpoint"])
        RVAE(8, 1, 32, device="cpu").load_state_dict(state, strict=True)
        assert payload["args"]["latent_dim"] == 8 and payload["epoch"] == t["epochs"] - 1
    best = json.loads((root / "cli" / "best_config.json").read_text())
    assert best == {k: v for k, v in out["best"].config.items()}
    assert out["launches"] == {"rot3_fwd": 0, "rot3_bwd": 0, "shear_fwd": 0, "shear_bwd": 0,
                               "upconv_fwd": 0, "upconv_bwd": 0, "phasemax_fwd": 0,
                               "phasemax_bwd": 0}


def test_best_config_keys_equal_jax(sweep, tmp_path, monkeypatch):
    """The JAX script's best_config.json for the same flags (its run_search
    replaced by one finished trial drawn from the same space) has the same keys
    and the same fixed values."""
    root, _ = sweep
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import train_rvae_raytune as jax_script
    from livae_tpu.sweep import Trial, sample_config

    def one_trial(trainable, param_space, **kw):
        config = sample_config(param_space, np.random.default_rng(0))
        return [Trial(0, config, status="done", history=[{"epoch": 1, "loss": 1.0,
                                                          "val_loss": 1.0}])]

    monkeypatch.setattr(jax_script, "run_search", one_trial)
    jax_script.run_hyperparameter_search(jax_script.build_argparser().parse_args(
        _argv(tmp_path, "jax", "--num-samples", "2", "--max-concurrent", "2")))
    want = json.loads((tmp_path / "jax" / "best_config.json").read_text())
    got = json.loads((root / "cli" / "best_config.json").read_text())
    assert list(got) == list(want)
    searched = {"lr", "beta", "weight_decay"}
    assert {k: v for k, v in got.items() if k not in searched} == \
        {k: v for k, v in want.items() if k not in searched}


def test_process_executor_trains_in_a_child(tmp_path):
    args = train_rvae_raytune.build_argparser().parse_args(
        _argv(tmp_path, "proc", "--executor", "process", "--max-concurrent", "1",
              "--num-samples", "1", "--epochs", "1"))
    out = train_rvae_raytune.run_hyperparameter_search(args)
    (trial,) = out["trials"]
    assert trial.status == "done" and trial.last("slot") == "0"
    assert trial.last("pid") != __import__("os").getpid()
    assert Path(trial.checkpoint).name == "trial_0.pt" and Path(trial.checkpoint).exists()
    assert (tmp_path / "proc" / "best_config.json").exists()


@pytest.mark.parametrize("donor_latent", [8, 16])
def test_pbt_exploit_takes_the_donors_weights_where_they_fit(tmp_path, capsys, donor_latent):
    """A report that answers with an exploit payload: the trial takes the
    donor's lr and beta, and, where the architecture matches, the donor
    checkpoint's weights with a fresh optimizer state."""
    frame = synthetic_mos2_frame(size=512, spacing=40.0, seed=0)[0]
    ds = AdaptiveLatticeDataset([frame], patch_size=32, padding=8, transform=default_transform,
                                device="cpu")
    dev = torch.device("cpu")
    compiled = train_rvae_raytune._build_compiled(ds, 32, 8, 8, 20.0, True, dev, 0)
    donor = RVAE(donor_latent, 1, 32, device="cpu", generator=torch.Generator().manual_seed(9))
    donor_path = tmp_path / "donor.pt"
    save_reference_checkpoint(donor_path, donor.state_dict())
    config = {"lr": 1e-3, "beta": 1.0, "weight_decay": 1e-5, "batch_size": 64, "latent_dim": 8,
              "patch_size": 32, "padding": 8, "val_split": 0.1, "epochs": 1, "gamma": 0.0}

    def report(**metrics):
        assert np.isfinite(metrics["loss"]) and metrics["checkpoint"] == str(tmp_path / "t.pt")
        return {"config": {**config, "lr": 5e-4, "beta": 2.0, "latent_dim": donor_latent},
                "checkpoint": str(donor_path)}

    train_rvae_raytune._trial_body(config, report, ds, compiled, str(tmp_path / "t.pt"), 0)
    trained, _ = load_reference_checkpoint(tmp_path / "t.pt")  # the epoch's weights
    model, optimizer = compiled[:2]
    assert config["lr"] == 5e-4 and config["beta"] == 2.0
    printed = capsys.readouterr().out
    if donor_latent == 8:
        assert "loaded donor checkpoint" in printed and not optimizer.state
        assert all(torch.equal(v, donor.state_dict()[k]) for k, v in model.state_dict().items())
    else:
        assert "kept its weights" in printed and optimizer.state
        assert all(torch.equal(v, trained[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def stacked_and_sequential(tmp_path_factory):
    """The same two trials as one stack of 2 and one after another (no
    scheduler, so both run every epoch)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("stacked")
    runs = {}
    for name, flags in (("stacked", ["--stacked", "2"]),
                        ("sequential", ["--max-concurrent", "1", "--scheduler", "none"])):
        args = train_rvae_raytune.build_argparser().parse_args(
            _argv(root, name, "--num-samples", "2", "--val-split", "0.2", *flags))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = train_rvae_raytune.run_hyperparameter_search(args)
        runs[name] = (out, buf.getvalue(),
                      json.loads((root / "ray_results" / name / "results.json").read_text()))
    return root, runs


def test_stacked_trains_k_trials_in_one_program(stacked_and_sequential):
    """--stacked 2 --num-samples 2 writes results.json and one checkpoint per
    trial, prints the scheduler's note, and its histories equal the
    sequential run's: the epoch metrics at rtol 1e-4 (under vmap the
    convolutions are grouped, their sums run in another order), the same
    steps and val batches (the val set of 118 sites at batch 64: a full batch
    and a ragged tail)."""
    root, runs = stacked_and_sequential
    (out, printed, stacked), (_, _, sequential) = runs["stacked"], runs["sequential"]
    assert "note: --stacked ignores --scheduler asha" in printed
    assert "(stacked x2)" in printed
    assert [t["trial_id"] for t in stacked] == [0, 1]
    for s, q in zip(stacked, sequential):
        assert s["status"] == q["status"] == "done" and s["config"] == q["config"]
        assert s["epochs"] == q["epochs"] == 2
        assert s["checkpoint"].endswith(f"trial_{s['trial_id']}.pt")
        state, payload = load_reference_checkpoint(s["checkpoint"])
        RVAE(8, 1, 32, device="cpu").load_state_dict(state, strict=True)
        assert payload["epoch"] == 1 and payload["args"] == q["config"]
        for hs, hq in zip(s["history"], q["history"]):
            assert hs["lanes"] == 2 and hs["val_batches"] == hq["val_batches"] == 2
            assert hs["epoch"] == hq["epoch"] and hs["steps"] == hq["steps"]
            for k in ("loss", "val_loss", "train_loss", "val_psnr"):
                np.testing.assert_allclose(hs[k], hq[k], rtol=1e-4, err_msg=k)
            assert hs["rot3_fwd"] == 0 and hs["train_patches_per_s"] > 0
    best = json.loads((root / "stacked" / "best_config.json").read_text())
    assert best == out["best"].config


def test_stacked_prints_the_executor_note_and_splits_structural_mixes(tmp_path, capsys):
    """Two latent widths in one round land in two stacks, each trained whole;
    --executor is replaced, with the JAX script's note."""
    args = train_rvae_raytune.build_argparser().parse_args(
        _argv(tmp_path, "mix", "--latent-dims", "4", "8", "--num-samples", "4", "--stacked", "4",
              "--epochs", "1", "--executor", "thread", "--scheduler", "none"))
    out = train_rvae_raytune.run_hyperparameter_search(args)
    printed = capsys.readouterr().out
    assert "note: --stacked replaces --executor thread" in printed
    assert "note: --stacked ignores" not in printed
    by_width = {}
    for t in out["trials"]:
        by_width.setdefault(t.config["latent_dim"], []).append(t)
    assert sorted(by_width) == [4, 8]
    for width, trials in by_width.items():
        for t in trials:
            assert t.status == "done" and t.history[-1]["lanes"] == len(trials)
            state, _ = load_reference_checkpoint(t.checkpoint)
            RVAE(width, 1, 32, device="cpu").load_state_dict(state, strict=True)
    assert printed.count("(stacked x") == 4


def test_with_best_consumes_vacancy_sweep_config(monkeypatch):
    """Every searched value of checkpoints/best_config_vacancy.json lands on
    the train_rvae args; the file is read, not written."""
    cfg_path = REPO / "checkpoints" / "best_config_vacancy.json"
    text = cfg_path.read_text()
    best = json.loads(text)
    captured = {}
    monkeypatch.setattr(train_rvae, "run_training", lambda args: captured.update(vars(args)))
    train_rvae_with_best.main(["--config", str(cfg_path), "--override-epochs", "2"])
    assert captured["lr"] == pytest.approx(best["lr"])
    assert captured["beta"] == pytest.approx(best["beta"])
    assert captured["gamma"] == pytest.approx(best["gamma"])
    assert captured["weight_decay"] == pytest.approx(best["weight_decay"])
    assert captured["latent_dim"] == int(best["latent_dim"])
    assert captured["batch_size"] == int(best["batch_size"])
    assert captured["no_per_patch_norm"] is (not best["normalize"])
    assert captured["epochs"] == 2
    captured.clear()
    train_rvae_with_best.main(["--config", str(cfg_path), "--", "--seed", "4"])
    assert captured["epochs"] == best["epochs"] and captured["seed"] == 4
    assert cfg_path.read_text() == text


def test_with_best_retrains_from_the_sweep(sweep):
    root, _ = sweep
    ckpt = root / "retrain" / "rvae_best.pt"
    out = train_rvae_with_best.main(
        ["--config", str(root / "cli" / "best_config.json"), "--override-epochs", "1",
         "--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512", "--patch-size", "32",
         "--padding", "8", "--no-tensorboard", "--checkpoint", str(ckpt)])
    best = json.loads((root / "cli" / "best_config.json").read_text())
    assert len(out["epochs"]) == 1 and np.isfinite(out["best_val"])
    state, payload = load_reference_checkpoint(out["final_checkpoint"])
    assert payload["args"]["lr"] == pytest.approx(best["lr"])
    RVAE(best["latent_dim"], 1, 32, device="cpu").load_state_dict(state, strict=True)


def test_analyze_gives_the_jax_scripts_csv(sweep, tmp_path, monkeypatch, capsys):
    root, _ = sweep
    results_dir = root / "ray_results" / "cli"
    analyze_raytune_results.main(["--results-dir", str(results_dir), "--top-k", "2",
                                  "--csv", str(tmp_path / "ours.csv")])
    ours = capsys.readouterr().out
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import analyze_raytune_results as jax_script

    monkeypatch.setattr(sys, "argv", ["analyze_raytune_results.py", "--results-dir",
                                      str(results_dir), "--top-k", "2", "--csv",
                                      str(tmp_path / "jax.csv")])
    jax_script.main()
    theirs = capsys.readouterr().out
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert ours.replace("ours.csv", "jax.csv") == theirs
    done = sum(t["status"] == "done" for t in json.loads((results_dir / "results.json").read_text()))
    assert f"Trials: 2 | done: {done}" in ours


def test_compare_training_methods_prints_its_summary(sweep, tmp_path, capsys):
    root, out = sweep
    rows = compare_training_methods.main(
        ["--checkpoint", out["best"].checkpoint, "--results-dir",
         str(root / "ray_results" / "cli"), "--out", str(tmp_path / "cmp.png")])
    printed = capsys.readouterr().out
    assert [r["method"] for r in rows] == ["standard", "sweep (best trial)"]
    assert "val_loss" in printed and "is better by" in printed
    assert (tmp_path / "cmp.png").stat().st_size > 1000


def test_raytune_deps_exit_zero(capsys):
    assert raytune_deps.main() == 0
    assert "OK: native sweep engine imports (livae_tpu_torch.sweep)" in capsys.readouterr().out
