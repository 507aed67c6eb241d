"""The port's schedules, beta annealing and STN parameter group against
livae_tpu.train.state (optax), on the CPU at f32.

Schedules are read at every step of a short run. Tolerance rtol 1e-6 plus
atol 2e-7 x lr: optax evaluates the cosine in float32, the port in float64,
and near a cosine's end 1 + cos(.) cancels, so the float32 rounding of the
cosine (6e-8) shows as an absolute error of that size times lr.

The train steps follow tests/test_torch_engine.py: same bridged weights, same
batches, the reparameterisation noise injected on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
from livae_tpu.models import init_params
from livae_tpu.train import engine as je
from livae_tpu.train import state as js
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train import state as ts
from livae_tpu_torch.utils.checkpoint import load_jax_params

PATCH, LATENT, B = 32, 8, 4
BETA = GAMMA = 10.0


def _assert_schedule(ours, theirs, steps, lr):
    got = np.array([ours(i) for i in range(steps)])
    want = np.array([float(theirs(i)) for i in range(steps)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7 * lr)


@pytest.mark.parametrize("lr,total,eta_min", [(1e-3, 24, 0.0), (3e-4, 7, 1e-5), (1e-3, 1, 0.0)])
def test_cosine_annealing_matches_optax(lr, total, eta_min):
    """Every step of the run and 5 steps past its end (constant there)."""
    _assert_schedule(ts.cosine_annealing(lr, total, eta_min),
                     js.cosine_annealing(lr, total, eta_min), total + 5, lr)


@pytest.mark.parametrize("t0,t_mult,total", [(4, 2, 30), (3, 1, 10), (5, 3, None), (4, 2, 10)])
def test_cosine_warm_restarts_matches_optax(t0, t_mult, total):
    """Past at least one restart, and past the horizon (no further restart)."""
    lr = 1e-3
    steps = (total or t0 * 32) + 3 * t0 * max(t_mult, 2) ** 3
    _assert_schedule(ts.cosine_warm_restarts(lr, t0, t_mult, total, eta_min=1e-6),
                     js.cosine_warm_restarts(lr, t0, t_mult, total, eta_min=1e-6), steps, lr)
    ours = ts.cosine_warm_restarts(lr, t0, t_mult, total)
    assert ours(t0) == pytest.approx(lr)  # the first restart
    assert ours(t0 - 1) < 0.5 * lr


@pytest.mark.parametrize("anneal", [False, True])
def test_beta_at_epoch_equals_jax(anneal):
    for epoch in range(30):
        for warm, ramp in ((5, 15), (1, 2), (0, 0)):
            assert ts.beta_at_epoch(epoch, 10.0, anneal, warm, ramp) == \
                js.beta_at_epoch(epoch, 10.0, anneal, warm, ramp)
    assert [ts.beta_at_epoch(e, 10.0, True, 1, 2) for e in range(4)] == [0.0, 0.0, 5.0, 10.0]


def test_step_schedule_reads_the_count_before_the_update():
    p = torch.nn.Parameter(torch.zeros(3))
    sched = ts.cosine_annealing(1e-3, 4)
    opt = ts.make_optimizer([p], sched, optimizer="adam")
    s = ts.make_schedule(opt, sched)
    seen = []
    for _ in range(5):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        s.step()
    assert seen == [sched(i) for i in range(5)]
    assert seen[0] == 1e-3 and seen[4] == 0.0
    state = s.state_dict()
    s2 = ts.make_schedule(ts.make_optimizer([p], sched), sched)
    s2.load_state_dict(state)
    assert s2.last_epoch == 5 and s2.get_last_lr() == s.get_last_lr()


def test_make_optimizer_rejects_what_jax_rejects():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        ts.make_optimizer(p, 1e-3, optimizer="sgd")
    with pytest.raises(ValueError, match="model is required"):
        ts.make_optimizer(p, 1e-3, stn_learning_rate=1e-4)
    opt = ts.make_optimizer(p, 1e-3, optimizer="adamw", weight_decay=1e-5)
    assert opt.param_groups[0]["weight_decay"] == 1e-5  # never torch's 0.01


@pytest.fixture(scope="module")
def jax_init():
    jmodel = jrvae.RVAE(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    return jmodel, params


@pytest.fixture
def eps_queue(monkeypatch):
    """Host-fed reparameterisation noise for the JAX model (one pop per call)."""
    queue = []

    def reparameterize(key, mu, logvar):
        eps = jax.pure_callback(lambda _: queue.pop(0),
                                jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                                jax.lax.stop_gradient(mu))
        return mu + eps * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    return queue


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _port(params):
    model = RVAE(LATENT, 1, PATCH, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return model


@pytest.mark.parametrize("freeze_stn", [False, True], ids=["stn_lr", "freeze_stn"])
def test_three_adamw_steps_with_an_stn_group_match(jax_init, eps_queue, rng, freeze_stn):
    """Three AdamW steps on two cosine schedules (main 1e-3, STN 1e-4, both
    over 3 steps, so the rate changes every step) against the JAX step.

    Metrics: 2e-4 at step 1 (identical weights), rtol 1e-3 after (the bound of
    tests/test_torch_engine.py); `grad_norm` at rtol 1e-3 every step, with
    freeze_stn too, where it still counts the STN's gradients. Weights after
    step 3: the existing test's bound (single elements within 2 lr per step,
    fewer than 0.1 % off by more than 1e-4). With freeze_stn the STN's weights
    keep their bits on both sides.
    """
    jmodel, params = jax_init
    jlr, jstn = js.cosine_annealing(1e-3, 3), js.cosine_annealing(1e-4, 3)
    tx = js.make_optimizer(jlr, optimizer="adamw", weight_decay=1e-5,
                           stn_learning_rate=None if freeze_stn else jstn,
                           freeze_stn=freeze_stn, params=params)
    state = js.TrainState.create(params, tx)
    jstep = je.make_rvae_train_step(jmodel, tx, canonical_weight=0.2, grad_max_norm=20.0)

    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lr, stn = ts.cosine_annealing(1e-3, 3), ts.cosine_annealing(1e-4, 3)
    opt = ts.make_optimizer(model, lr, optimizer="adamw", weight_decay=1e-5,
                            stn_learning_rate=None if freeze_stn else stn,
                            freeze_stn=freeze_stn)
    sched = ts.make_schedule(opt, lr, None if freeze_stn else stn)
    assert len(opt.param_groups) == (1 if freeze_stn else 2)
    tstep = te.make_rvae_train_step(model, opt, canonical_weight=0.2, grad_max_norm=20.0,
                                    scheduler=sched, device="cpu")

    for i in range(3):
        x = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        x_rot = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        angle = rng.uniform(0, 2 * np.pi, B).astype(np.float32)
        eps = rng.standard_normal((B, LATENT)).astype(np.float32)
        eps_queue.append(eps)
        assert opt.param_groups[0]["lr"] == pytest.approx(float(jlr(i)), rel=1e-6)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(x_rot), jnp.asarray(angle),
                          jax.random.key(i), BETA, GAMMA)
        tm = te.metrics_to_host(tstep(_nchw(x), _nchw(x_rot), torch.from_numpy(angle),
                                      BETA, GAMMA, eps=torch.from_numpy(eps)))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(tm["grad_norm"], np.asarray(jm["grad_norm"]), rtol=1e-3)
        for k in jm:
            tol = dict(atol=2e-4, rtol=2e-4) if i == 0 else dict(atol=2e-4, rtol=1e-3)
            np.testing.assert_allclose(tm[k], np.asarray(jm[k]), err_msg=f"step {i} {k}", **tol)
    assert sched.last_epoch == 3

    jstate = {k: v.numpy() for k, v in _port(state.params).state_dict().items()}
    after = model.state_dict()
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel() for k, v in after.items()])
    assert diffs.max() <= 2 * 1e-3 * 3
    assert np.mean(diffs > 1e-4) < 1e-3
    stn_keys = [k for k in after if "rotation_stn" in k]
    assert len(stn_keys) == 8
    for k in stn_keys:
        if freeze_stn:
            assert torch.equal(after[k], before[k]), k
            np.testing.assert_array_equal(jstate[k], before[k].numpy(), err_msg=k)
        else:  # moved, and by the STN's smaller rate: at most ~lr per step
            assert not torch.equal(after[k], before[k]), k
            assert (after[k] - before[k]).abs().max() <= 2 * 1e-4 * 3, k
    assert not torch.equal(after["decoder.fc.weight"], before["decoder.fc.weight"])
