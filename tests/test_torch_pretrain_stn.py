"""STN pretraining (livae_tpu_torch.scripts.pretrain_stn) against the JAX
script on the CPU: the parser, two optimizer steps on injected batches, and
the checkpoint round trip into `train_rvae --stn-checkpoint`.

The JAX step is scripts/pretrain_stn.py's, built here from the same pieces
(optax.multi_transform of AdamW over the STN and set_to_zero elsewhere, the
engine's global-norm clip at 5.0, the cycle loss of two predict_theta
passes), on the same weights and batch. Loss and grad norm agree at rtol 1e-3;
the STN's leaves at rtol 1e-3 (atol 1e-6) but for one element in a thousand
(f32 convolutions summed in another order change the last bits of each
gradient, and Adam's first steps are about lr whatever the gradient's size);
every other leaf keeps its bits.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.losses import cycle_consistency_loss as jax_cycle_loss
from livae_tpu.models import init_params
from livae_tpu.train.engine import _clip_by_global_norm as jax_clip
from livae_tpu.utils import checkpoint as jc
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.ops import _build
from livae_tpu_torch.scripts import pretrain_stn, train_rvae
from livae_tpu_torch.utils import checkpoint as tc

REPO = Path(__file__).resolve().parent.parent
PATCH, LATENT, B = 32, 8, 8
SMALL = ["--cpu", "--synthetic", "1", "--synthetic-size", "512", "--patch-size", "32",
         "--padding", "8", "--batch-size", "64", "--latent-dim", "8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                      getattr(a.type, "__name__", None), a.const)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_has_the_jax_parsers_options_and_defaults(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    jax_script = __import__("pretrain_stn")
    ours, theirs = pretrain_stn.build_argparser(), jax_script.build_argparser()
    assert _surface(ours) == _surface(theirs)
    assert vars(ours.parse_args([])) == vars(theirs.parse_args([]))


def _jax_step(jmodel, lr, wd):
    """scripts/pretrain_stn.py's optimizer and jitted train step."""

    def is_stn(path, _):
        return "stn" if any(getattr(p, "key", None) == "rotation_stn" for p in path) else "frozen"

    def make_tx(params):
        labels = jax.tree_util.tree_map_with_path(is_stn, params)
        return optax.multi_transform(
            {"stn": optax.adamw(lr, weight_decay=wd), "frozen": optax.set_to_zero()}, labels)

    def loss_fn(p, x, x_rot, angle):
        theta = jmodel.apply(p, x, method="predict_theta")
        theta_rot = jmodel.apply(p, x_rot, method="predict_theta")
        return jax_cycle_loss(theta, theta_rot, angle)

    def step(tx, max_norm, params, opt_state, x, x_rot, angle):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, x_rot, angle)
        grads, gnorm = jax_clip(grads, max_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, gnorm

    return make_tx, jax.jit(step, static_argnums=(0, 1))


@pytest.mark.parametrize("max_norm", [5.0, 0.01], ids=["script", "clipped"])
def test_two_steps_match_the_jax_step(rng, max_norm):
    """At the script's bound of 5.0, and at 0.01, where the clip takes effect
    on every step."""
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    model = RVAE(LATENT, 1, PATCH, device="cpu")
    tc.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = pretrain_stn.make_stn_optimizer(model, 1e-3, 1e-5)
    step = pretrain_stn.make_stn_pretrain_step(model, opt, max_norm)
    make_tx, jstep = _jax_step(jmodel, 1e-3, 1e-5)
    tx = make_tx(params)
    opt_state = tx.init(params)

    norms = []
    for _ in range(2):
        x = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        x_rot = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        angle = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
        params, opt_state, jloss, jnorm = jstep(tx, max_norm, params, opt_state, jnp.asarray(x),
                                                jnp.asarray(x_rot), jnp.asarray(angle))
        loss, gnorm = step(*(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in (x, x_rot)),
                           torch.from_numpy(angle))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-3)
        norms.append(float(gnorm))
    if max_norm < 1:
        assert norms == pytest.approx([max_norm] * 2)  # the reported norm is min(norm, bound)

    want = jc.params_to_torch_state(jax.tree_util.tree_map(np.asarray, params),
                                    jc.rvae_spec(PATCH, LATENT))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if "rotation_stn" in k:
            assert not torch.equal(v, before[k]), f"{k} did not move"
            # An element whose gradient is near 0 can take its Adam step (about
            # lr) another way, as in tests/test_torch_engine.py: every element
            # within 2 lr per step, all but one in a thousand at rtol 1e-3.
            diff = np.abs(v.numpy() - want[k])
            assert diff.max() <= 2 * 1e-3 * 2, k
            assert np.mean(diff > 1e-6 + 1e-3 * np.abs(want[k])) < 1e-3, k
        else:
            assert torch.equal(v, before[k]), f"{k} moved"
            np.testing.assert_array_equal(want[k], before[k].numpy(), err_msg=k)


def _stn_of(model):
    return model.encoder.rotation_stn.state_dict()


def test_checkpoint_round_trips_into_train_rvae(tmp_path, monkeypatch, capsys):
    """Two epochs on the CPU (no nvcc looked for), the best val epoch saved in
    stn_spec's layout, then `train_rvae --stn-checkpoint --freeze-stn` loads
    it: the trained model's STN holds the checkpoint's bits."""
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("looked for nvcc on the CPU"))
    ckpt = tmp_path / "stn.pt"
    args = pretrain_stn.build_argparser().parse_args(
        [*SMALL, "--epochs", "2", "--checkpoint", str(ckpt)])
    out = pretrain_stn.run_pretrain(args)
    assert out["kernel_build_s"] == 0.0 and "kernel build" not in capsys.readouterr().out
    assert [e["epoch"] for e in out["epochs"]] == [0, 1]
    n, n_train, n_val = out["sites"]
    for e in out["epochs"]:
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
        assert e["steps"] == n_train // 64 and e["val_batches"] == -(-n_val // 64)
        assert all(v == 0 for v in e["launches"].values())  # plain versions on the CPU
    payload = tc.load_checkpoint(ckpt)
    assert set(payload) == {"rotation_stn", "epoch", "best_val", "args"}
    assert set(payload["rotation_stn"]) == {f"{key}.{w}" for _, key, _, _ in jc.stn_spec(PATCH)
                                            for w in ("weight", "bias")}
    assert payload["best_val"] == out["best_val"] == min(e["val_loss"] for e in out["epochs"])
    assert payload["args"]["batch_size"] == 64
    if payload["epoch"] == 1:  # the last epoch was the best: the model holds its bits
        for k, v in _stn_of(out["model"]).items():
            assert torch.equal(payload["rotation_stn"][k], v), k
    # the JAX package reads it as an STN subtree
    stn_params = jc.torch_state_to_params(payload["rotation_stn"], jc.stn_spec(PATCH))["params"]
    assert stn_params["loc_fc1"]["kernel"].shape == (32, 2)

    trained = _train_from(tmp_path / "rvae", ckpt)
    for k, v in payload["rotation_stn"].items():
        assert torch.equal(_stn_of(trained)[k], v), k


def _train_from(out_dir, stn_ckpt):
    args = train_rvae.build_argparser().parse_args(
        [*SMALL, "--no-amp", "--no-tensorboard", "--epochs", "1", "--freeze-stn",
         "--stn-checkpoint", str(stn_ckpt), "--checkpoint", str(out_dir / "rvae.pt")])
    out = train_rvae.run_training(args)
    assert np.isfinite(out["epochs"][0]["metrics"]["train_loss"])
    return out["model"]


def test_train_rvae_loads_a_jax_written_stn_checkpoint(tmp_path):
    """The file the JAX script writes: params_to_torch_state of the STN subtree
    under "rotation_stn", saved by the JAX package's save_checkpoint."""
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(5), "sample": jax.random.key(6)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    params = jax.tree_util.tree_map(np.asarray, params)
    ckpt = tmp_path / "jax_stn.pt"
    jc.save_checkpoint(ckpt, {
        "rotation_stn": jc.params_to_torch_state(
            params["params"]["encoder"]["rotation_stn"], jc.stn_spec(PATCH)),
        "epoch": 0, "best_val": 1.0, "args": {}})
    want = RVAE(LATENT, 1, PATCH, device="cpu")
    tc.load_jax_params(want, params)
    trained = _train_from(tmp_path / "rvae", ckpt)
    for k, v in _stn_of(want).items():
        assert torch.equal(_stn_of(trained)[k], v), k


def test_none_gradients_count_as_zero_in_the_clip():
    """Only the STN gets gradients; the clip's norm is theirs alone, and a
    parameter without a gradient is left as it is."""
    model = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(2))
    opt = pretrain_stn.make_stn_optimizer(model, 1e-3, 1e-5)
    step = pretrain_stn.make_stn_pretrain_step(model, opt, 1e-3)  # clips every step
    g = torch.Generator().manual_seed(3)
    x, x_rot = torch.rand((2, 4, 1, PATCH, PATCH), generator=g)
    _, gnorm = step(x, x_rot, torch.rand(4, generator=g))
    grads = [p.grad for p in model.encoder.rotation_stn.parameters()]
    assert all(gr is not None for gr in grads)
    assert all(p.grad is None for n, p in model.named_parameters() if "rotation_stn" not in n)
    assert float(gnorm) == pytest.approx(1e-3)
    total = torch.sqrt(sum((gr * gr).sum() for gr in grads))
    assert float(total) == pytest.approx(1e-3, rel=1e-5)  # scaled in place to the bound
