"""Losses of the PyTorch port against livae_tpu.losses (rtol 1e-5: the same
f32 reductions, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu import losses as jl
from livae_tpu_torch import losses as tl

RTOL = 1e-5


@pytest.fixture
def batch(rng):
    B, P, D = 6, 16, 8
    return dict(
        recon=rng.random((B, P, P, 1)).astype(np.float32),
        x=rng.random((B, P, P, 1)).astype(np.float32),
        mu=rng.standard_normal((B, D)).astype(np.float32),
        logvar=(0.3 * rng.standard_normal((B, D))).astype(np.float32),
        theta=rng.uniform(-np.pi, np.pi, (B, 1)).astype(np.float32),
        theta_rot=rng.uniform(-np.pi, np.pi, (B, 1)).astype(np.float32),
        angle=rng.uniform(0, 2 * np.pi, (B,)).astype(np.float32),
    )


def _j(b, *names):
    return [jnp.asarray(b[n]) for n in names]


def _t(b, *names):
    out = []
    for n in names:
        v = b[n]
        out.append(torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if v.ndim == 4 else v))
    return out


def _close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-7)


def test_vae_loss(batch):
    names = ("recon", "x", "mu", "logvar")
    _close(tl.vae_loss(*_t(batch, *names), beta=3.0), jl.vae_loss(*_j(batch, *names), beta=3.0))


@pytest.mark.parametrize("gamma,use_diversity", [(0.0, False), (10.0, False), (10.0, True)])
def test_rvae_loss(batch, gamma, use_diversity):
    names = ("recon", "x", "mu", "logvar", "theta", "theta_rot", "angle")
    kw = dict(beta=10.0, gamma=gamma, use_diversity=use_diversity)
    _close(tl.rvae_loss(*_t(batch, *names), **kw), jl.rvae_loss(*_j(batch, *names), **kw))


@pytest.mark.parametrize("flat", [False, True])
def test_angle_losses(batch, flat):
    th, thr = batch["theta"], batch["theta_rot"]
    if flat:
        th, thr = th[:, 0], thr[:, 0]
    t = torch.from_numpy
    _close(tl.circular_distance(t(th), t(thr)), jl.circular_distance(jnp.asarray(th), jnp.asarray(thr)))
    _close(tl.cycle_consistency_loss(t(th), t(thr), t(batch["angle"])),
           jl.cycle_consistency_loss(jnp.asarray(th), jnp.asarray(thr), jnp.asarray(batch["angle"])))
    _close(tl.rotation_diversity_loss(t(th), 1.0), jl.rotation_diversity_loss(jnp.asarray(th), 1.0))
