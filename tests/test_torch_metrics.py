"""The port's metrics (livae_tpu_torch.metrics) against livae_tpu.metrics on
the CPU: the same numpy inputs, NHWC for the JAX package and NCHW (CHW for a
single image) for the port.

Tolerances: the reductions run in float32 in another order, so the float
metrics agree at rtol 1e-5 (atol 1e-6); the model's metrics pass through the
f32 convolutions of both packages, held at 2e-4 as in
tests/test_torch_models.py. Atom detection runs the same numpy peak finder on
the same arrays and must agree exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.metrics as jm
import livae_tpu.models.rvae as jrvae
import livae_tpu.models.vae as jvae
from livae_tpu.models import init_params
from livae_tpu_torch import metrics as tm
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.utils.checkpoint import load_jax_params


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_exports_every_name_of_the_jax_metrics():
    assert set(jm.__all__) <= set(tm.__all__)
    assert all(callable(getattr(tm, n)) for n in jm.__all__)


@pytest.fixture
def pair(rng):
    a = rng.random((3, 24, 20, 1)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


def test_compute_psnr_and_ssim(pair):
    a, b = pair
    _close(tm.compute_psnr(_nchw(a), _nchw(b)), jm.compute_psnr(a, b))
    _close(tm.compute_psnr(_nchw(a), _nchw(b), max_val=2.0), jm.compute_psnr(a, b, max_val=2.0))
    assert tm.compute_psnr(_nchw(a), _nchw(a)) == jm.compute_psnr(a, a) == float("inf")
    _close(tm.compute_ssim(_nchw(a), _nchw(b)), jm.compute_ssim(a, b))
    _close(tm.compute_ssim(_nchw(a), _nchw(b), window_size=5), jm.compute_ssim(a, b, 5))
    # a single image: CHW in the port, HWC in the JAX package
    _close(tm.compute_ssim(_nchw(a)[0], _nchw(b)[0]), jm.compute_ssim(a[0], b[0]))
    # torch tensors go in as they are
    _close(tm.compute_ssim(torch.from_numpy(_nchw(a)), torch.from_numpy(_nchw(b))),
           jm.compute_ssim(a, b))


def test_compute_reconstruction_and_latent_metrics(rng, pair):
    a, b = pair
    got = tm.compute_reconstruction_metrics(_nchw(a), _nchw(b))
    want = jm.compute_reconstruction_metrics(a, b)
    assert list(got) == list(want) == ["mse", "rmse", "mae", "psnr", "ssim"]
    for k in want:
        _close(got[k], want[k], rtol=1e-5)
    mu = rng.standard_normal((16, 8)).astype(np.float32)
    logvar = (0.3 * rng.standard_normal((16, 8))).astype(np.float32)
    got = tm.compute_latent_metrics(mu, logvar)
    want = jm.compute_latent_metrics(mu, logvar)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("shape", [(12, 10), (12, 10, 1), (1, 12, 10), (12, 10, 3),
                                   (3, 12, 10), (4, 12, 10)])
def test_to_2d_takes_hwc_and_chw(rng, shape):
    img = rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(tm._to_2d(img), jm._to_2d(img))
    np.testing.assert_array_equal(tm._to_2d(torch.from_numpy(img)), jm._to_2d(img))


def test_compute_atom_detection_metrics(rng):
    frame, _ = synthetic_mos2_frame(size=128, spacing=16.0, seed=0)
    frame = frame.astype(np.float32)
    noisy = frame + 0.1 * rng.standard_normal(frame.shape).astype(np.float32)
    for orig, rec in ((frame, noisy), (frame[None], noisy[None]),
                      (frame[..., None], noisy[..., None])):
        got = tm.compute_atom_detection_metrics(orig, rec, 16.0)
        want = jm.compute_atom_detection_metrics(orig, rec, 16.0)
        assert got == want and got["n_original_atoms"] > 10
    flat = np.zeros((32, 32), np.float32)  # no peak at all
    assert tm.compute_atom_detection_metrics(flat, frame[:32, :32], 8.0) == \
        jm.compute_atom_detection_metrics(flat, frame[:32, :32], 8.0)
    with pytest.raises(ValueError, match="positive"):
        tm.compute_atom_detection_metrics(frame, noisy, 0.0)


@pytest.mark.parametrize("kind", ["rvae", "vae"])
def test_compute_all_metrics_matches_with_the_noise_injected(rng, monkeypatch, kind):
    patch, latent, B = 32, 8, 4
    jmod, port_cls = (jrvae, RVAE) if kind == "rvae" else (jvae, VAE)
    jmodel = (jrvae.RVAE if kind == "rvae" else jvae.VAE)(latent_dim=latent, patch_size=patch)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, patch, patch, 1)))
    tmodel = port_cls(latent, 1, patch, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    x = rng.random((B, patch, patch, 1)).astype(np.float32)
    eps = rng.standard_normal((B, latent)).astype(np.float32)
    monkeypatch.setattr(jmod, "reparameterize",
                        lambda key, mu, logvar: mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar))
    # the JAX model's apply, jitted: op by op it takes a minute on the CPU
    want = jm.compute_all_metrics(types.SimpleNamespace(apply=jax.jit(jmodel.apply)), params, x,
                                  lattice_spacing=8.0)
    got = tm.compute_all_metrics(tmodel, _nchw(x), eps=torch.from_numpy(eps),
                                 lattice_spacing=8.0)
    assert list(got) == list(want)
    for k in want:
        if k.startswith(("n_", "atom_")):
            continue  # peaks of two reconstructions that differ in the last bits
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
    assert got["n_original_atoms"] == want["n_original_atoms"]
    # the noise from a generator: finite, and the same for the same seed
    a = tm.compute_all_metrics(tmodel, torch.from_numpy(_nchw(x)))
    b = tm.compute_all_metrics(tmodel, torch.from_numpy(_nchw(x)),
                               generator=torch.Generator().manual_seed(0))
    assert a == b and all(np.isfinite(v) for v in a.values())
