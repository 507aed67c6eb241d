"""Reference-format checkpoints cross both ways between the port and
livae_tpu.utils.checkpoint, for the RVAE and the VAE, on the CPU at f32.

Outputs are compared on the deterministic paths (encode, decode) at 2e-4,
the model parity bound of tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
import livae_tpu.models.vae as jvae
from livae_tpu.models import init_params
from livae_tpu.utils import checkpoint as jc
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.utils import checkpoint as tc

PATCH, LATENT = 32, 8
ATOL = 2e-4
KINDS = {
    "rvae": (jrvae.RVAE, RVAE, jc.rvae_spec, tc.rvae_spec),
    "vae": (jvae.VAE, VAE, jc.vae_spec, tc.vae_spec),
}


def _jax_model(kind, seed=0):
    jcls = KINDS[kind][0]
    jmodel = jcls(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(seed), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    return jmodel, params


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _assert_same_outputs(jmodel, params, tmodel, rng):
    x = rng.random((4, PATCH, PATCH, 1)).astype(np.float32)
    z = rng.standard_normal((4, LATENT)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = tmodel.encode(_nchw(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    if hasattr(tmodel, "decode"):
        want = jmodel.apply(params, jnp.asarray(z), method="decode")
        with torch.no_grad():
            got = tmodel.decode(torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_specs_equal_the_jax_specs(kind):
    assert KINDS[kind][3](PATCH, LATENT) == KINDS[kind][2](PATCH, LATENT)
    assert KINDS[kind][3](128, 16) == KINDS[kind][2](128, 16)
    assert tc.stn_spec(PATCH) == jc.stn_spec(PATCH)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_written_checkpoint_loads_in_jax(kind, tmp_path, rng):
    jmodel, _ = _jax_model(kind)
    tmodel = KINDS[kind][1](LATENT, 1, PATCH, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    path = tmp_path / "port.pt"
    tc.save_reference_checkpoint(path, tmodel.state_dict(), epoch=3, best_val=1.5,
                                 args={"patch_size": PATCH, "no_per_patch_norm": True})
    params, payload = jc.load_reference_checkpoint(path, KINDS[kind][2](PATCH, LATENT))
    assert set(payload) == {"model_state", "optimizer_state", "epoch", "best_val", "args"}
    assert payload["epoch"] == 3 and payload["best_val"] == 1.5
    assert payload["args"]["no_per_patch_norm"] is True
    _assert_same_outputs(jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel, rng)


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_written_checkpoint_loads_strictly(kind, tmp_path, rng):
    jmodel, params = _jax_model(kind, seed=4)
    path = tmp_path / "jax.pt"
    jc.save_reference_checkpoint(path, params, KINDS[kind][2](PATCH, LATENT), epoch=7,
                                 best_val=0.25, args={"latent_dim": LATENT})
    state, payload = tc.load_reference_checkpoint(path)
    tmodel = KINDS[kind][1](LATENT, 1, PATCH, device="cpu")
    tmodel.load_state_dict(state, strict=True)
    assert payload["epoch"] == 7 and payload["args"] == {"latent_dim": LATENT}
    _assert_same_outputs(jmodel, params, tmodel, rng)


def test_stn_only_checkpoint_both_ways(tmp_path, rng):
    """The {"rotation_stn": ...} layout of stn_spec: a JAX-written file loads
    strictly into the port's STN, and a port-written one converts back."""
    jmodel, params = _jax_model("rvae", seed=2)
    stn_params = params["params"]["encoder"]["rotation_stn"]
    path = tmp_path / "stn_jax.pt"
    jc.save_checkpoint(path, {"rotation_stn": jc.params_to_torch_state(stn_params,
                                                                        jc.stn_spec(PATCH))})
    tmodel = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(1))
    stn_state = tc.clean_state_dict(tc.load_checkpoint(path)["rotation_stn"])
    tmodel.encoder.rotation_stn.load_state_dict(stn_state, strict=True)
    x = rng.random((4, PATCH, PATCH, 1)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x), method="encode")[2]
    with torch.no_grad():
        got = tmodel.encoder.predict_theta(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    path = tmp_path / "stn_port.pt"
    tc.save_checkpoint(path, {"rotation_stn": tmodel.encoder.rotation_stn.state_dict()})
    back = jc.torch_state_to_params(jc.load_checkpoint(path)["rotation_stn"],
                                    jc.stn_spec(PATCH))["params"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, dict(stn_params)))):
        np.testing.assert_array_equal(a, b)


def test_orig_mod_prefixes_are_stripped(tmp_path):
    tmodel = VAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0))
    compiled = {f"_orig_mod.{k}": v for k, v in tmodel.state_dict().items()}
    assert set(tc.clean_state_dict(compiled)) == set(tmodel.state_dict())
    path = tmp_path / "compiled.pt"
    tc.save_checkpoint(path, {"model_state": compiled, "epoch": 0})
    state, _ = tc.load_reference_checkpoint(path)
    fresh = VAE(LATENT, 1, PATCH, device="cpu")
    fresh.load_state_dict(state, strict=True)
    assert all(torch.equal(v, tmodel.state_dict()[k]) for k, v in fresh.state_dict().items())
    tc.save_reference_checkpoint(path, compiled)
    assert set(tc.load_checkpoint(path)["model_state"]) == set(tmodel.state_dict())


@pytest.mark.parametrize("kind", list(KINDS))
def test_torch_state_to_params_inverts_the_bridge_bit_for_bit(kind):
    _, params = _jax_model(kind, seed=6)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    spec = KINDS[kind][3](PATCH, LATENT)
    state = tc.params_to_torch_state(params_np, spec)
    back = tc.torch_state_to_params(state, spec)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(params_np)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # and the other way round, from the port's own state dict
    tmodel = KINDS[kind][1](LATENT, 1, PATCH, device="cpu")
    again = tc.params_to_torch_state(tc.torch_state_to_params(tmodel.state_dict(), spec), spec)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(again[k], v.numpy(), err_msg=k)
    # the JAX converter gives the same tree
    theirs = jc.torch_state_to_params(state, KINDS[kind][2](PATCH, LATENT))
    for a, b in zip(jax.tree_util.tree_leaves(theirs), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
