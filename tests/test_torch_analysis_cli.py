"""The port's analysis entry points (livae_tpu_torch.scripts.visualizations,
plot_tsne_by_image, verify_rotational_invariance) run in-process with --cpu:
their parsers against the JAX scripts', the files they write on a checkpoint
of the port's train_rvae (2 epochs on a 512-pixel synthetic frame, patch 32,
latent 8) and on one the JAX package's checkpoint writer wrote, and the
loader's choices (model type, per-patch normalisation, sweep trials)."""

import argparse
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.models import init_params
from livae_tpu.utils import checkpoint as jc
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.ops import _build
from livae_tpu_torch.scripts import (
    plot_tsne_by_image,
    train_rvae,
    verify_rotational_invariance,
    visualizations,
)
from livae_tpu_torch.utils import checkpoint as tc

REPO = Path(__file__).resolve().parent.parent
FRAME = ["--cpu", "--synthetic", "1", "--synthetic-size", "512"]
PLOTS = ["latent_embeddings.png", "clusters/image_0_clusters.png",
         "atom_clusters/image_0_atom_clusters.png"] + [
    f"windows/latent_hist_scatter_ws{w}.png" for w in (10, 20, 30, 60, 90, 120)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """_final of two epochs of the port's train_rvae without per-patch norm;
    nvcc is never looked for."""
    out_dir = tmp_path_factory.mktemp("rvae")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(_build, "_nvcc", lambda: pytest.fail("looked for nvcc on the CPU"))
    try:
        args = train_rvae.build_argparser().parse_args(
            [*FRAME, "--no-amp", "--patch-size", "32", "--padding", "8", "--batch-size", "64",
             "--latent-dim", "8", "--no-tensorboard", "--epochs", "2", "--no-per-patch-norm",
             "--checkpoint", str(out_dir / "rvae.pt")])
        out = train_rvae.run_training(args)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    assert out["kernel_build_s"] == 0.0
    return Path(out["final_checkpoint"])


def _surface(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                      getattr(a.type, "__name__", None), a.const)
            for a in parser._actions if a.option_strings and a.dest != "help"}


class _Parser(Exception):
    pass


@pytest.mark.parametrize("port", [visualizations, plot_tsne_by_image,
                                  verify_rotational_invariance],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_parser_has_the_jax_scripts_options_and_defaults(monkeypatch, port):
    """The JAX scripts build their parser inside main(): it is caught at its
    parse_args."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    jax_script = __import__(port.__name__.rsplit(".", 1)[1])

    def catch(self, *a, **k):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parser) as caught:
        jax_script.main()
    theirs = caught.value.args[0]
    monkeypatch.undo()
    ours = port.build_argparser()
    assert _surface(ours) == _surface(theirs)
    assert vars(ours.parse_args([])) == vars(theirs.parse_args([]))


def test_visualizations_writes_the_jax_scripts_plots(trained, tmp_path, capsys):
    plots = tmp_path / "plots"
    visualizations.main([*FRAME, "--checkpoint", str(trained), "--plots-dir", str(plots)])
    printed = capsys.readouterr().out
    assert "Loaded rVAE (latent 8, patch 32, per-patch norm off)" in printed
    for name in PLOTS:
        assert (plots / name).stat().st_size > 0, name


def test_plot_tsne_by_image_writes_its_plot(trained, tmp_path):
    out = tmp_path / "runs" / "plots" / "embedding_by_image3.png"
    plot_tsne_by_image.main([*FRAME, "--checkpoint", str(trained), "--out", str(out)])
    assert out.stat().st_size > 0


def test_verify_rotational_invariance_on_a_checkpoint_and_a_sweep(trained, tmp_path, capsys):
    (result,) = verify_rotational_invariance.main([*FRAME, "--checkpoint", str(trained),
                                                   "--n-patches", "8"])
    assert np.isfinite(result["euclidean_distance"]) and -1 <= result["cosine_similarity"] <= 1
    assert result["verdict"].endswith("rotation-invariant")
    assert f"{trained}: cos=" in capsys.readouterr().out
    # a sweep: trials without a checkpoint drop out, the rest go best val_loss first
    trials = [{"val_loss": 3.0, "checkpoint": "c.pt"}, {"val_loss": 1.0},
              {"val_loss": 2.0, "checkpoint": str(trained)}, {"checkpoint": "d.pt"}]
    (tmp_path / "results.json").write_text(json.dumps(trials))
    assert verify_rotational_invariance.sweep_checkpoints(str(tmp_path), 2) == [str(trained),
                                                                               "c.pt"]
    (swept,) = verify_rotational_invariance.main([*FRAME, "--sweep-dir", str(tmp_path),
                                                  "--top-k", "1", "--n-patches", "8"])
    assert swept == result
    with pytest.raises(SystemExit, match="No results.json"):
        verify_rotational_invariance.main([*FRAME, "--sweep-dir", str(tmp_path / "none")])


def test_visualizations_on_a_checkpoint_the_jax_package_wrote(tmp_path, monkeypatch, capsys):
    """The layout the JAX train_rvae writes (its writer, its parsed arguments)
    loads strictly and drives the whole script."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import train_rvae as jax_train_rvae

    jargs = jax_train_rvae.build_argparser().parse_args(
        ["--cpu", "--patch-size", "32", "--latent-dim", "8", "--padding", "8"])
    jmodel = jrvae.RVAE(latent_dim=8, patch_size=32)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, 32, 32, 1)))
    ckpt = tmp_path / "jax_rvae_final.pt"
    jc.save_reference_checkpoint(ckpt, params, jc.rvae_spec(32, 8), epoch=1, best_val=2.0,
                                 args={k: v for k, v in vars(jargs).items()
                                       if not k.startswith("_")})
    model, is_rvae, latent, patch, payload = visualizations.load_model_from_checkpoint(
        str(ckpt), device="cpu")
    assert is_rvae and (latent, patch) == (8, 32) and payload["epoch"] == 1
    want = tc.params_to_torch_state(jax.tree_util.tree_map(np.asarray, params),
                                    tc.rvae_spec(32, 8))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert not model.training

    plots = tmp_path / "plots"
    visualizations.main([*FRAME, "--checkpoint", str(ckpt), "--plots-dir", str(plots)])
    assert "per-patch norm on" in capsys.readouterr().out
    for name in PLOTS:
        assert (plots / name).stat().st_size > 0, name


def test_model_type_from_the_keys_and_the_flags(tmp_path, trained):
    vae = VAE(8, 1, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    path = tmp_path / "vae.pt"
    tc.save_reference_checkpoint(path, vae.state_dict(), args={"latent_dim": 8, "patch_size": 32})
    model, is_rvae, *_ = visualizations.load_model_from_checkpoint(str(path), device="cpu")
    assert not is_rvae and isinstance(model, VAE)
    assert visualizations.load_model_from_checkpoint(str(trained), "rvae", "cpu")[1]
    with pytest.raises(RuntimeError):  # an rVAE's keys do not load into a VAE
        visualizations.load_model_from_checkpoint(str(trained), "vae", "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):  # the card unless asked otherwise
        torch.cuda.is_available() or visualizations.load_model_from_checkpoint(str(path))


def test_checkpoint_normalize_honours_sweep_args():
    """A sweep trial's `normalize` first, then the trainers' no_per_patch_norm
    (tests/test_scripts.py holds the JAX script to the same)."""
    cn = visualizations.checkpoint_normalize
    assert cn({"args": {"normalize": False}}) is False
    assert cn({"args": {"normalize": True, "no_per_patch_norm": True}}) is True
    assert cn({"args": {"no_per_patch_norm": True}}) is False
    assert cn({"args": {"no_per_patch_norm": False}}) is True
    assert cn({"args": {}}) is True and cn({}) is True
