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
def _pair(patch, latent, in_channels=1, fast_resample=True):
    """(JAX model, its params, the port's model with the same weights); the
    tests only run forward passes, so each configuration is built once."""
    jmodel = jrvae.RVAE(latent_dim=latent, in_channels=in_channels, patch_size=patch,
                        fast_resample=fast_resample)
    params = init_params(
        jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((1, patch, patch, in_channels)),
    )
    tmodel = RVAE(latent, in_channels, patch, fast_resample=fast_resample, device="cpu")
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


# (patch, latent, in_channels, fast_resample): the two SIZES, the exact
# bilinear rotations, and three channels (the per-shear rotation path)
CONFIGS = [(*s, 1, True) for s in SIZES] + [(32, 8, 1, False), (32, 8, 3, True),
                                            (32, 8, 3, False)]
CONFIG_IDS = ["32-8", "64-16", "exact", "C3", "C3-exact"]


@pytest.mark.parametrize("patch,latent,in_channels,fast_resample", CONFIGS[2:],
                         ids=CONFIG_IDS[2:])
def test_encode_matches_resample_variants(rng, patch, latent, in_channels, fast_resample):
    jmodel, params, tmodel = _pair(patch, latent, in_channels, fast_resample)
    x = rng.random((4, patch, patch, in_channels)).astype(np.float32)
    want = jax.jit(lambda p, a: jmodel.apply(p, a, method="encode"))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.encode(_nchw(x))
    for name, g, w in zip(("mu", "logvar", "theta"), got, want):
        np.testing.assert_allclose(_as_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("patch,latent,in_channels,fast_resample", CONFIGS, ids=CONFIG_IDS)
def test_train_forward_paired_matches(rng, monkeypatch, patch, latent, in_channels,
                                      fast_resample):
    jmodel, params, tmodel = _pair(patch, latent, in_channels, fast_resample)
    B = 4
    x = rng.random((B, patch, patch, in_channels)).astype(np.float32)
    x_rot = rng.random((B, patch, patch, in_channels)).astype(np.float32)
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


def test_weight_bridge_takes_three_channels():
    """The bridge converts any C_in: the input convolutions and the last
    decoder stage carry three channels, HWIO -> OIHW."""
    _, params, tmodel = _pair(32, 8, 3, True)
    state = tmodel.state_dict()
    p = params["params"]
    for key, path in [
        ("encoder.rotation_stn.localization.0", ("encoder", "rotation_stn", "loc_conv0", "conv")),
        ("encoder.conv_layers.0", ("encoder", "conv0", "conv")),
        ("decoder.deconv_layers.14", ("decoder", "up_conv3", "conv")),
    ]:
        kernel = np.asarray(functools.reduce(lambda n, k: n[k], path, p)["kernel"])
        assert 3 in state[f"{key}.weight"].shape[:2], key
        np.testing.assert_array_equal(state[f"{key}.weight"].numpy(),
                                      kernel.transpose(3, 2, 0, 1), err_msg=key)


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
