"""Train step, fused eval and fused encode of the PyTorch port against
livae_tpu.train.engine, at f32 on the CPU (patch 32, latent 8, batch 4).

Both sides start from the same bridged params and see the same batches. The
reparameterisation noise is injected on the JAX side: a monkeypatched
livae_tpu.models.rvae.reparameterize takes eps from the host through
jax.pure_callback, one queued array per call, and the port gets the same
arrays as `eps`. The eval's augmentation draws are derived as the JAX
package derives them from its keys and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.data.pipeline import AugmentConfig, _sample_aug, pad_frames
from livae_tpu.models import init_params
from livae_tpu.train import engine as je
from livae_tpu.train.state import TrainState, make_optimizer as jax_optimizer
from livae_tpu_torch.data.pipeline import PairedDraws
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils.checkpoint import load_jax_params

PATCH, LATENT, B, PAD = 32, 8, 4, 8
BETA = GAMMA = 10.0


@pytest.fixture(scope="module")
def jax_init():
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    return jmodel, params


def _port(params):
    model = RVAE(LATENT, 1, PATCH, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return model


@pytest.fixture
def eps_queue(monkeypatch):
    """Host-fed reparameterisation noise for the JAX model (one pop per call)."""
    queue = []

    def reparameterize(key, mu, logvar):
        # mu as an (unused) operand keeps XLA from hoisting the call out of
        # the fused eval's loop
        eps = jax.pure_callback(lambda _: queue.pop(0),
                                jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                                jax.lax.stop_gradient(mu))
        return mu + eps * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    return queue


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_three_train_steps_match(jax_init, eps_queue, rng):
    """Metrics each step and params after step 3.

    Step 1 sees identical params: 2e-4 (the model parity bound). Later steps
    start from params that differ by f32 rounding amplified by Adam's
    m / sqrt(v) normalisation, so metrics hold at rtol 1e-3; for the params
    see the bound below.
    """
    jmodel, params = jax_init
    tx = jax_optimizer(1e-3, optimizer="adamw", weight_decay=1e-5)
    state = TrainState.create(params, tx)
    jstep = je.make_rvae_train_step(jmodel, tx, canonical_weight=0.2, grad_max_norm=20.0)

    model = _port(params)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    tstep = te.make_rvae_train_step(model, opt, canonical_weight=0.2, grad_max_norm=20.0,
                                    device="cpu")

    for i in range(3):
        x = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        x_rot = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        angle = rng.uniform(0, 2 * np.pi, B).astype(np.float32)
        eps = rng.standard_normal((B, LATENT)).astype(np.float32)
        eps_queue.append(eps)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(x_rot), jnp.asarray(angle),
                          jax.random.key(i), BETA, GAMMA)
        tm = te.metrics_to_host(tstep(_nchw(x), _nchw(x_rot), torch.from_numpy(angle),
                                      BETA, GAMMA, eps=torch.from_numpy(eps)))
        assert set(tm) == set(jm)
        for k in jm:
            tol = dict(atol=2e-4, rtol=2e-4) if i == 0 else dict(atol=2e-4, rtol=1e-3)
            np.testing.assert_allclose(tm[k], np.asarray(jm[k]), err_msg=f"step {i} {k}", **tol)
    assert not eps_queue

    jstate = {k: v.numpy() for k, v in _port(state.params).state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in model.state_dict().items()])
    # An element whose gradient is near 0 can take its Adam step (size ~lr) in
    # the other direction, so single elements may differ by up to 2 lr per
    # step; all but a few in ten thousand must agree to 1e-4.
    assert diffs.max() <= 2 * 1e-3 * 3
    assert np.mean(diffs > 1e-4) < 1e-3


@pytest.fixture
def sites(rng):
    N, H, W = 2, 120, 140
    P2 = PATCH + 2 * PAD
    margin = (P2 + 16) // 2 + 8
    raw = rng.random((N, H, W)).astype(np.float32)
    coords = np.stack([rng.uniform(20, H - 20, 16), rng.uniform(20, W - 20, 16)],
                      axis=1).astype(np.float32)
    img_idx = rng.integers(0, N, 16).astype(np.int32)
    idx = rng.permutation(16)[: 2 * B].reshape(2, B).astype(np.int32)
    return raw, margin, img_idx, coords, idx


def test_fused_eval_matches(jax_init, eps_queue, sites, rng):
    """Every eval metric of 2 batches at 2e-4 (the model parity bound)."""
    jmodel, params = jax_init
    raw, margin, img_idx, coords, idx = sites
    cfg = AugmentConfig()
    key = jax.random.key(5)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(len(idx))]
    eps_queue.extend(eps)
    jeval = je.make_fused_rvae_eval(jmodel, patch_size=PATCH, padding=PAD, cfg=cfg,
                                    margin=margin, canonical_weight=0.2)
    want = je.metrics_to_host(jeval(params, pad_frames(jnp.asarray(raw), margin),
                                    jnp.asarray(img_idx), jnp.asarray(coords),
                                    jnp.asarray(idx), key, BETA, GAMMA))
    assert not eps_queue

    draws = []
    for i in range(len(idx)):  # engine.py: fold_in(key, i) -> (ke, ks); ke -> (kaug, kangle)
        ke, _ = jax.random.split(jax.random.fold_in(key, i))
        kaug, kangle = jax.random.split(ke)
        scale, _, fh, fv, jy, jx = (np.array(v) for v in _sample_aug(kaug, B, cfg))
        angle = np.array(jax.random.uniform(kangle, (B,), minval=0.0, maxval=2 * jnp.pi))
        t = torch.from_numpy
        draws.append(PairedDraws(t(scale), t(fh), t(fv), t(jy).long(), t(jx).long(), t(angle)))

    model = _port(params)
    teval = te.make_fused_rvae_eval(model, patch_size=PATCH, padding=PAD, cfg=cfg,
                                    margin=margin, canonical_weight=0.2, device="cpu")
    fp = torch.nn.functional.pad(torch.from_numpy(raw), (margin,) * 4)
    got = te.metrics_to_host(teval(fp, torch.from_numpy(img_idx).long(),
                                   torch.from_numpy(coords), torch.from_numpy(idx).long(),
                                   None, BETA, GAMMA, draws=draws,
                                   eps=[torch.from_numpy(e) for e in eps]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-4, err_msg=k)


def test_fused_encode_matches(jax_init, sites):
    jmodel, params = jax_init
    raw, margin, img_idx, coords, idx = sites
    jenc = je.make_fused_encode(jmodel, patch_size=PATCH, padding=PAD, margin=margin)
    want = jenc(params, pad_frames(jnp.asarray(raw), margin), jnp.asarray(img_idx),
                jnp.asarray(coords), jnp.asarray(idx))
    tenc = te.make_fused_encode(_port(params), patch_size=PATCH, padding=PAD, margin=margin,
                                device="cpu")
    fp = torch.nn.functional.pad(torch.from_numpy(raw), (margin,) * 4)
    got = tenc(fp, torch.from_numpy(img_idx).long(), torch.from_numpy(coords),
               torch.from_numpy(idx).long())
    for name, g, w in zip(("mu", "logvar", "theta"), got, want):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, err_msg=name)


def test_clip_by_global_norm_is_the_jax_formula():
    grads = [torch.full((3,), 4.0), torch.full((2, 2), 3.0)]  # norm sqrt(48 + 36)
    gnorm = te._clip_by_global_norm(grads, 5.0)
    assert float(gnorm) == 5.0
    total = torch.sqrt(sum((g * g).sum() for g in grads))
    np.testing.assert_allclose(float(total), 5.0, rtol=1e-6)
    small = [torch.full((4,), 1e-3)]
    assert float(te._clip_by_global_norm(small, 5.0)) == pytest.approx(2e-3)
    assert float(small[0][0]) == pytest.approx(1e-3)
