"""The port's training entry points (livae_tpu_torch.scripts.train_rvae and
train_vae): the parsers against the JAX scripts' parsers, and run_training
in-process on the CPU at a small size (one 512-pixel synthetic frame, patch
32, padding 8, batch 64, latent 8, f32)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from livae_tpu.utils import checkpoint as jc
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.scripts import train_rvae, train_vae
from livae_tpu_torch.utils import checkpoint as tc

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512",
         "--patch-size", "32", "--padding", "8", "--batch-size", "64", "--latent-dim", "8",
         "--no-tensorboard"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(parser):
    """{option strings: (dest, default, nargs, type name, const)} of a parser."""
    out = {}
    for a in parser._actions:
        if a.option_strings and a.dest != "help":
            out[tuple(a.option_strings)] = (a.dest, a.default, a.nargs,
                                            getattr(a.type, "__name__", None), a.const)
    return out


# train_vae's options for spatial-VAE (--arch spatial), which the JAX script lacks
SPATIAL_DESTS = {"arch", "p_hidden_dim", "p_num_layers", "q_hidden_dim", "q_num_layers",
                 "theta_prior", "dx_scale", "no_rotate", "no_translate"}


@pytest.mark.parametrize("name", ["train_rvae", "train_vae"])
def test_parser_has_the_jax_parsers_options_and_defaults(monkeypatch, name):
    """The JAX script's options with their defaults, and for train_vae the
    spatial-VAE options besides, defaulting to the convolutional VAE."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    jax_script = __import__(name)
    ours = {"train_rvae": train_rvae, "train_vae": train_vae}[name].build_argparser()
    theirs = jax_script.build_argparser()
    extra = SPATIAL_DESTS if name == "train_vae" else set()
    surface = _surface(ours)
    assert {v[0] for k, v in surface.items() if k not in _surface(theirs)} == extra
    assert {k: v for k, v in surface.items() if v[0] not in extra} == _surface(theirs)
    defaults = vars(ours.parse_args([]))
    assert {k: v for k, v in defaults.items() if k not in extra} == vars(theirs.parse_args([]))
    if extra:
        assert defaults["arch"] == "vae"


def _run_rvae(tmp_path, name, *extra):
    ckpt = tmp_path / name / "rvae.pt"
    args = train_rvae.build_argparser().parse_args(
        [*SMALL, "--seed", "3", "--checkpoint", str(ckpt), *extra])
    return train_rvae.run_training(args), ckpt


def test_train_rvae_writes_reference_checkpoints(tmp_path, capsys):
    out, ckpt = _run_rvae(tmp_path, "a", "--epochs", "2", "--no-per-patch-norm",
                          "--beta-annealing", "--beta-warmup-epochs", "1",
                          "--beta-annealing-epochs", "2", "--stn-lr", "1e-4")
    final = ckpt.with_name("rvae_final.pt")
    assert ckpt.exists() and final.exists() and out["final_checkpoint"] == str(final)
    assert [e["beta"] for e in out["epochs"]] == [0.0, 0.0]
    assert all(np.isfinite(v) for e in out["epochs"] for v in e["metrics"].values())
    assert {"train_loss", "train_grad_norm", "val_loss", "val_psnr", "val_canonical_ssim",
            "val_rotation_std"} <= set(out["epochs"][0]["metrics"])
    steps = out["epochs"][0]["steps"]
    assert steps == out["sites"][1] // 64 and out["scheduler"].last_epoch == 2 * steps
    # the two cosine schedules, read at the last step taken
    last = 2 * steps - 1
    want = [lr * 0.5 * (1 + np.cos(np.pi * last / (2 * steps))) for lr in (1e-3, 1e-4)]
    np.testing.assert_allclose(out["epochs"][-1]["lr_last_step"], want, rtol=1e-9)
    # no kernel launch on the CPU
    assert all(v == 0 for e in out["epochs"] for v in e["launches"].values())

    # the files load through the JAX loader, and carry the run's arguments
    for path in (ckpt, final):
        params, payload = jc.load_reference_checkpoint(path, jc.rvae_spec(32, 8))
        assert set(payload) == {"model_state", "optimizer_state", "epoch", "best_val", "args"}
        assert payload["args"]["no_per_patch_norm"] is True
        assert payload["args"]["patch_size"] == 32 and payload["args"]["seed"] == 3
        assert params["params"]["encoder"]["rotation_stn"]["loc_fc1"]["kernel"].shape == (32, 2)
    assert payload["epoch"] == 1 and payload["best_val"] == out["best_val"]
    # a fresh model loaded from _final encodes bit-equal to the trained one
    state, _ = tc.load_reference_checkpoint(final)
    fresh = RVAE(8, 1, 32, device="cpu")
    fresh.load_state_dict(state, strict=True)
    x = torch.rand((4, 1, 32, 32), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(fresh.encode(x), out["model"].encode(x)))
    assert "saved best checkpoint" in capsys.readouterr().out


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path, capsys, monkeypatch):
    """One epoch, an interruption (--stop-after-epochs 1), then --resume, against
    two straight epochs: the same weights, optimizer state and digests."""
    monkeypatch.setenv("LIVAE_PARAM_HASH", "1")
    straight, a_ckpt = _run_rvae(tmp_path, "a", "--epochs", "2", "--stn-lr", "1e-4")
    first, b_ckpt = _run_rvae(tmp_path, "b", "--epochs", "2", "--stn-lr", "1e-4", "--resume",
                              "--stop-after-epochs", "1")
    assert len(first["epochs"]) == 1 and (tmp_path / "b" / "resume_rvae" / "step_0.pt").exists()
    capsys.readouterr()
    resumed, _ = _run_rvae(tmp_path, "b", "--epochs", "2", "--stn-lr", "1e-4", "--resume")
    printed = capsys.readouterr().out
    assert "Resumed from" in printed and "at epoch 1" in printed
    assert resumed["start_epoch"] == 1 and [e["epoch"] for e in resumed["epochs"]] == [1]
    assert resumed["resumed_digest"] == first["epochs"][0]["digest"]
    assert f"PARAMHASH resumed {resumed['resumed_digest']}" in printed
    assert [e["digest"] for e in straight["epochs"]] == [first["epochs"][0]["digest"],
                                                         resumed["epochs"][0]["digest"]]
    a = tc.load_checkpoint(a_ckpt.with_name("rvae_final.pt"))["model_state"]
    b = tc.load_checkpoint(b_ckpt.with_name("rvae_final.pt"))["model_state"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"param {k} diverged"
    assert resumed["epochs"][0]["metrics"] == straight["epochs"][1]["metrics"]

    # a changed seed cannot resume
    with pytest.raises(SystemExit, match="differs from the checkpoint's seed 3"):
        _run_rvae(tmp_path, "b", "--epochs", "2", "--stn-lr", "1e-4", "--resume", "--seed", "4")


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    out, _ = _run_rvae(tmp_path, "c", "--epochs", "1", "--resume")
    assert "no checkpoint in" in capsys.readouterr().out and out["start_epoch"] == 0
    assert (tmp_path / "c" / "resume_rvae" / "step_0.pt").exists()


def test_freeze_stn_leaves_the_stns_bits(tmp_path):
    stn_ckpt = tmp_path / "stn.pt"
    donor = RVAE(8, 1, 32, device="cpu", generator=torch.Generator().manual_seed(9))
    tc.save_checkpoint(stn_ckpt, {"rotation_stn": {
        f"_orig_mod.{k}": v for k, v in donor.encoder.rotation_stn.state_dict().items()}})
    out, _ = _run_rvae(tmp_path, "f", "--epochs", "1", "--freeze-stn",
                       "--stn-checkpoint", str(stn_ckpt))
    got = out["model"].encoder.rotation_stn.state_dict()
    for k, v in donor.encoder.rotation_stn.state_dict().items():
        assert torch.equal(got[k], v), k  # loaded, then untouched by training
    assert len(out["optimizer"].param_groups) == 1
    held = {id(p) for g in out["optimizer"].param_groups for p in g["params"]}
    assert not any(id(p) in held for p in out["model"].encoder.rotation_stn.parameters())
    assert np.isfinite(out["epochs"][0]["metrics"]["train_grad_norm"])


@pytest.mark.parametrize("flags", [["--num-devices", "2"], ["--model-parallel", "2"],
                                   ["--num-devices", "4", "--model-parallel", "2"]])
@pytest.mark.parametrize("script", [train_rvae, train_vae], ids=["rvae", "vae"])
def test_devices_and_model_parallel_train_or_exit_as_jax(tmp_path, capfd, script, flags):
    """`--num-devices 2` trains on 2 gloo ranks (data parallelism);
    `--model-parallel 2` alone exits as the JAX trainers do (1 device is not
    divisible by 2 model ways); `--num-devices 4 --model-parallel 2` trains on
    a 2x2 mesh with the large dense layers split (the val set's 118 sites
    leave a ragged tail that every rank runs whole): its train loss within
    rel 1e-4 of one device, and its `_final` checkpoint loads into the port
    and through the JAX loader with `args.model_parallel == 2`."""
    ckpt = tmp_path / "m.pt"
    common = [*SMALL, "--epochs", "1", "--val-split", "0.2"]
    args = script.build_argparser().parse_args([*common, *flags, "--checkpoint", str(ckpt)])
    if flags == ["--model-parallel", "2"]:
        with pytest.raises(SystemExit,
                           match="--num-devices 1 must be divisible by --model-parallel 2"):
            script.run_training(args)
        return
    out = script.run_training(args)
    printed = capfd.readouterr().out
    assert len(out["epochs"]) == 1
    assert all(np.isfinite(v) for k, v in out["epochs"][0]["metrics"].items()
               if k.startswith("train_"))
    final = ckpt.with_name("m_final.pt")
    assert ckpt.exists() and final.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.pt", "m_final.pt"]
    if "--model-parallel" not in flags:
        return
    n_split = 5 if script is train_rvae else 4  # the STN's first dense layer too
    assert f"2-D mesh: 2 data x 2 model {{'data': 2, 'model': 2}}; {n_split} model-sharded" \
        in printed
    assert out["sites"][2] % 64 and out["epochs"][0]["val_batches"] == 2  # a ragged tail
    one = script.run_training(script.build_argparser().parse_args(
        [*common, "--checkpoint", str(tmp_path / "one" / "m.pt")]))
    np.testing.assert_allclose(out["epochs"][0]["metrics"]["train_loss"],
                               one["epochs"][0]["metrics"]["train_loss"], rtol=1e-4)
    # the file holds the one-device model: it loads into the port and through JAX's loader
    state, payload = tc.load_reference_checkpoint(final)
    assert payload["args"]["model_parallel"] == 2 and payload["args"]["num_devices"] == "4"
    fresh = (RVAE if script is train_rvae else VAE)(8, 1, 32, device="cpu")
    fresh.load_state_dict(state, strict=True)
    assert isinstance(out["model"].decoder.fc, torch.nn.Linear)  # gathered back
    for k, v in out["model"].state_dict().items():
        assert torch.equal(v, state[k]), k
    scripts_dir = str(REPO / "scripts")
    sys.path.insert(0, scripts_dir)
    try:
        from visualizations import load_model_from_checkpoint

        *_, is_rvae, _, _, jpayload = load_model_from_checkpoint(str(final))
        assert is_rvae == (script is train_rvae)
        assert jpayload["args"]["model_parallel"] == 2
    finally:
        sys.path.remove(scripts_dir)


def test_train_vae_pure_tensor_parallel(tmp_path, capfd):
    """`train_vae --num-devices 2 --model-parallel 2`: one data way and two
    model ways (JAX's tests/test_scripts.py:151-166): it prints the JAX line
    and writes its checkpoint."""
    ckpt = tmp_path / "vae_mp.pt"
    args = train_vae.build_argparser().parse_args(
        [*SMALL, "--epochs", "1", "--num-devices", "2", "--model-parallel", "2",
         "--checkpoint", str(ckpt)])
    out = train_vae.run_training(args)
    assert "2-D mesh: 1 data x 2 model" in capfd.readouterr().out
    assert ckpt.exists() and ckpt.with_name("vae_mp_final.pt").exists()
    assert np.isfinite(out["epochs"][0]["metrics"]["train_loss"])


def test_auto_devices_and_ignored_flags(tmp_path, capsys):
    out, _ = _run_rvae(tmp_path, "n", "--epochs", "1", "--num-devices", "auto",
                       "--num-workers", "2", "--compile", "--exact-resample")
    printed = capsys.readouterr().out
    assert "--num-workers is accepted and ignored" in printed
    assert "--compile is accepted and ignored" in printed
    assert out["model"].fast_resample is False


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_cpu = [a for a in SMALL if a != "--cpu"]
    for script in (train_rvae, train_vae):
        with pytest.raises(RuntimeError, match="CUDA"):
            script.run_training(script.build_argparser().parse_args(no_cpu))


def test_train_vae_one_epoch(tmp_path, capsys):
    ckpt = tmp_path / "v" / "vae.pt"
    args = train_vae.build_argparser().parse_args(
        [*SMALL, "--epochs", "1", "--beta-annealing", "--checkpoint", str(ckpt)])
    out = train_vae.run_training(args)
    assert out["epochs"][0]["beta"] == pytest.approx(0.1)  # (epoch + 1) / 10
    assert all(np.isfinite(v) for v in out["epochs"][0]["metrics"].values())
    assert "val_rotation_std" not in out["epochs"][0]["metrics"]
    final = ckpt.with_name("vae_final.pt")
    assert ckpt.exists() and final.exists()
    params, payload = jc.load_reference_checkpoint(final, jc.vae_spec(32, 8))
    assert payload["args"]["scheduler_t0"] == 10 and payload["args"]["no_per_patch_norm"] is False
    assert params["params"]["decoder"]["deconv0"]["kernel"].shape == (4, 4, 256, 128)
    state, _ = tc.load_reference_checkpoint(ckpt)
    fresh = VAE(8, 1, 32, device="cpu")
    fresh.load_state_dict(state, strict=True)
    assert "VAE: " in capsys.readouterr().out


def test_tensorboard_and_profile_outputs(tmp_path):
    log_dir = tmp_path / "runs"
    flags = [a for a in SMALL if a != "--no-tensorboard"]
    args = train_rvae.build_argparser().parse_args(
        [*flags, "--epochs", "2", "--vis-every", "1", "--vis-samples", "4", "--profile",
         "--log-dir", str(log_dir), "--checkpoint", str(tmp_path / "t" / "rvae.pt")])
    train_rvae.run_training(args)
    trace = json.loads((log_dir / "profile" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train.step", "forward", "backward", "eval.batch"} <= names  # the program's spans
    assert any(p.name.startswith("events.out.tfevents") for p in log_dir.rglob("*"))
