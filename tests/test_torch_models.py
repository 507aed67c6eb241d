"""The PyTorch port's RVAE against livae_tpu's, through bridged weights.

The JAX model is initialised with livae_tpu.models.init_params, its params
convert through livae_tpu_torch.utils.checkpoint.load_jax_params, and both
models see the same inputs (NHWC <-> NCHW). The reparameterisation noise is
injected on the JAX side by monkeypatching livae_tpu.models.rvae.reparameterize
and handed to the port as `eps`. Tolerance 2e-4, that of the existing torch
parity suite (tests/test_models.py): f32 convolutions summed in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.models import init_params
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.utils.checkpoint import load_jax_params

ATOL = 2e-4
SIZES = [(32, 8), (64, 16)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _as_nhwc(t):
    t = t.detach().float().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


@functools.lru_cache(maxsize=None)
def _pair(patch, latent):
    """(JAX model, its params, the port's model with the same weights); the
    tests only run forward passes, so each size is built once."""
    jmodel = jrvae.RVAE(latent_dim=latent, patch_size=patch)
    params = init_params(
        jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((1, patch, patch, 1)),
    )
    tmodel = RVAE(latent, 1, patch, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("patch,latent", SIZES)
def test_encode_matches(rng, patch, latent):
    jmodel, params, tmodel = _pair(patch, latent)
    x = rng.random((4, patch, patch, 1)).astype(np.float32)
    want = jax.jit(lambda p, a: jmodel.apply(p, a, method="encode"))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.encode(_nchw(x))
    for name, g, w in zip(("mu", "logvar", "theta"), got, want):
        np.testing.assert_allclose(_as_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("patch,latent", SIZES)
def test_train_forward_paired_matches(rng, monkeypatch, patch, latent):
    jmodel, params, tmodel = _pair(patch, latent)
    B = 4
    x = rng.random((B, patch, patch, 1)).astype(np.float32)
    x_rot = rng.random((B, patch, patch, 1)).astype(np.float32)
    eps = rng.standard_normal((B, latent)).astype(np.float32)
    monkeypatch.setattr(
        jrvae, "reparameterize",
        lambda key, mu, logvar: mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar),
    )
    want = jax.jit(lambda p, a, b: jmodel.apply(
        p, a, b, rngs={"sample": jax.random.key(2)}, method="train_forward_paired"
    ))(params, jnp.asarray(x), jnp.asarray(x_rot))
    with torch.no_grad():
        got = tmodel.train_forward_paired(_nchw(x), _nchw(x_rot), eps=torch.from_numpy(eps))
    names = ("rotated_recon", "recon", "theta", "mu", "logvar", "x_canonical", "theta_rot")
    assert len(got) == len(want) == 7
    for name, g, w in zip(names, got, want):
        assert _as_nhwc(g).shape == np.asarray(w).shape, name
        np.testing.assert_allclose(_as_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)


def test_state_dict_keys_are_the_reference_layout():
    _, params, tmodel = _pair(32, 8)
    keys = set(tmodel.state_dict())
    assert "encoder.rotation_stn.localization.0.weight" in keys
    assert "decoder.deconv_layers.14.weight" in keys
    assert {f"encoder.conv_layers.{i}.weight" for i in (0, 2, 4, 6)} <= keys


def test_bfloat16_policy_dtypes(rng):
    """The rotations take the compute dtype; the inverse rotation, the dense
    heads and the angles stay float32 (livae_tpu/models/rvae.py:106-114,
    290-299)."""
    tmodel = RVAE(8, 1, 32, "bfloat16", device="cpu", generator=torch.Generator().manual_seed(0))
    x = _nchw(rng.random((2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        rr, recon, theta, mu, logvar, xc, theta_rot = tmodel.train_forward_paired(
            x, x.bfloat16(), generator=torch.Generator().manual_seed(1))
    assert xc.dtype == torch.bfloat16
    for t in (rr, recon, theta, mu, logvar, theta_rot):
        assert t.dtype == torch.float32
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 4), (2, 4, 8, 8)])
def test_decoder_upsample_and_pad_are_the_torch_layers(rng, shape):
    """The slice forms equal nn.Upsample(2, bilinear, align_corners=False)
    (1e-6: the two taps are summed in another order) and ReflectionPad2d(1)."""
    from livae_tpu_torch.models.rvae import _reflect_pad1, _upsample2x

    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    up = torch.nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(_upsample2x(x).numpy(), up(x).numpy(), atol=1e-6)
    if min(shape[2:]) > 1:
        assert torch.equal(_reflect_pad1(x), torch.nn.ReflectionPad2d(1)(x))
