"""The analysis path of the port against livae_tpu on the CPU: the model
methods and `native_available` of the two faults the port had (F1, F2),
`collect_stats` and `check_invariance` of the analysis scripts against the
JAX scripts' (scripts/visualizations.py, verify_rotational_invariance.py),
and `evaluate_rotation_invariance` against livae_tpu.train.engine's.

Both packages get the same weights (the JAX model's, through
`load_jax_params`), the same frame (a 512-pixel synthetic frame, patch 32,
padding 16: 549 sites) and the same reparameterisation noise, injected on the
JAX side by monkeypatching livae_tpu.models.rvae.reparameterize. Tolerance
2e-4, that of tests/test_torch_models.py: f32 convolutions summed in another
order. The angle error is held at an absolute 2e-4 as well: it wraps theta's
difference through sin and cos, so a theta near +-pi that lands on the other
side in one package moves it by no more than its own rounding.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.data.datasets import AdaptiveLatticeDataset as JaxDataset
from livae_tpu.models import init_params
from livae_tpu.ops import native as jnative
from livae_tpu.train import engine as je
from livae_tpu_torch.data.datasets import AdaptiveLatticeDataset
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE, RotationSTN
from livae_tpu_torch.ops import native as tnative
from livae_tpu_torch.scripts import verify_rotational_invariance, visualizations
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.utils.checkpoint import load_jax_params

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-4
PATCH, LATENT, PADDING = 32, 8, 16


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
    import verify_rotational_invariance as jvri
    import visualizations as jvis

    return jvis, jvri


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX RVAE, its params, the port's RVAE with the same weights)."""
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    tmodel = RVAE(LATENT, 1, PATCH, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@functools.lru_cache(maxsize=None)
def _datasets():
    """The un-augmented analysis datasets of one frame, in both packages."""
    frame, _ = synthetic_mos2_frame(size=512, spacing=40.0, seed=0)
    kw = dict(patch_size=PATCH, padding=PADDING, transform=None)
    return JaxDataset([frame], **kw), AdaptiveLatticeDataset([frame], **kw, device="cpu")


def _inject(monkeypatch, eps):
    """JAX's reparameterisation noise := the first rows of eps."""
    monkeypatch.setattr(
        jrvae, "reparameterize",
        lambda key, mu, logvar: mu + jnp.asarray(eps[: mu.shape[0]]) * jnp.exp(0.5 * logvar))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_predict_theta_decode_and_rotation_matrix_match(rng):
    jmodel, params, tmodel = _models()
    x = rng.random((4, PATCH, PATCH, 1)).astype(np.float32)
    z = rng.standard_normal((4, LATENT)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (4, 1)).astype(np.float32)
    want_theta = jax.jit(functools.partial(jmodel.apply, method="predict_theta"))(
        params, jnp.asarray(x))
    want_recon = jax.jit(functools.partial(jmodel.apply, method="decode"))(params, jnp.asarray(z))
    with torch.no_grad():
        got_theta = tmodel.predict_theta(_nchw(x))
        got_recon = tmodel.decode(torch.from_numpy(z))
        assert torch.equal(got_theta, tmodel.encode(_nchw(x))[2])
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want_theta), atol=ATOL)
    np.testing.assert_allclose(got_recon.numpy().transpose(0, 2, 3, 1), np.asarray(want_recon),
                               atol=ATOL)
    for th in (theta, theta[:, 0]):  # [B, 1] and [B]
        got = RotationSTN.get_rotation_matrix(torch.from_numpy(th))
        want = jrvae.RotationSTN.get_rotation_matrix(jnp.asarray(th))
        assert got.shape == (4, 2, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_native_available_matches_the_jax_package():
    assert "native_available" in tnative.__all__
    assert tnative.native_available() == jnative.native_available()
    assert isinstance(tnative.native_available(), bool)


def test_site_tables_agree():
    jds, tds = _datasets()
    assert len(tds) == len(jds) == 549
    for a, b in zip(tds.sample_coords, jds.sample_coords):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_collect_stats_matches_jax(monkeypatch, jax_scripts):
    """Batches of 64, the ragged tail of 37 too; the same noise rows in
    every batch, as the JAX script's key(0)."""
    jvis, _ = jax_scripts
    jmodel, params, tmodel = _models()
    jds, tds = _datasets()
    eps = np.random.default_rng(1).standard_normal((64, LATENT)).astype(np.float32)
    _inject(monkeypatch, eps)
    want = jvis.collect_stats(jmodel, params, jds, 64, is_rvae=True)
    got = visualizations.collect_stats(tmodel, tds, 64, True, eps=torch.from_numpy(eps))
    for name, g, w in zip(("mu", "logvar", "rec_err"), got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)
    assert got[3] == want[3] and len(got[3]) == 549
    # without eps: the noise of a generator seeded 0 per batch, so each batch's
    # statistics do not depend on the batches before it
    a = visualizations.collect_stats(tmodel, tds, 64, True)
    b = visualizations.collect_stats(tmodel, tds, 128, True)
    np.testing.assert_array_equal(a[0], b[0])  # mu has no noise
    np.testing.assert_array_equal(a[2][:64], b[2][:64])


def test_collect_stats_of_a_plain_vae_uses_its_reconstruction():
    from livae_tpu_torch.models.vae import VAE

    _, tds = _datasets()
    vae = VAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0))
    eps = torch.zeros((64, LATENT))
    mu, logvar, err, idx_map = visualizations.collect_stats(vae, tds, 64, False, eps=eps)
    x = tds.batch_at(np.arange(64))
    with torch.no_grad():
        recon, want_mu, want_logvar = vae(x, eps)
    np.testing.assert_array_equal(mu[:64], want_mu.numpy())
    np.testing.assert_allclose(err[:64], ((recon - x) ** 2).mean((1, 2, 3)).numpy(), rtol=1e-6)
    assert mu.shape == logvar.shape == (549, LATENT) and idx_map[-1] == (0, 548)


def test_check_invariance_matches_jax(jax_scripts):
    _, jvri = jax_scripts
    jmodel, params, tmodel = _models()
    jds, tds = _datasets()
    idx = np.linspace(0, len(tds) - 1, 16).astype(int)
    want = jvri.check_invariance(jmodel, params, jds.batch_at(idx))
    got = verify_rotational_invariance.check_invariance(tmodel, tds.batch_at(idx))
    assert got["verdict"] == want["verdict"]
    for k in ("euclidean_distance", "cosine_similarity"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_evaluate_rotation_invariance_matches_jax(rng, monkeypatch):
    """Eight angles on 8 probes. The JAX probe step is jitted once for every
    angle, so the injected noise is one array for all of them; the port gets
    the same array for each angle."""
    jmodel, params, tmodel = _models()
    probes = rng.random((8, PATCH, PATCH, 1)).astype(np.float32)
    eps = rng.standard_normal((8, LATENT)).astype(np.float32)
    _inject(monkeypatch, eps)
    want = je.evaluate_rotation_invariance(jmodel, params, jnp.asarray(probes))
    got = te.evaluate_rotation_invariance(tmodel, _nchw(probes),
                                          eps=[torch.from_numpy(eps)] * 8)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    # one angle: no angle error, as in JAX; the default noise is reproducible
    one = te.evaluate_rotation_invariance(tmodel, _nchw(probes), angles=(30,))
    assert one["angle_error"] == 0.0 and one["latent_variance"] == 0.0
    assert one == te.evaluate_rotation_invariance(tmodel, _nchw(probes), angles=(30,))
