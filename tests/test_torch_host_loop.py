"""The port's host-loop trainers (`train_one_epoch`, `evaluate`,
`train_rvae_one_epoch`, `evaluate_rvae`, `_accumulate_epoch`) against
livae_tpu.train.engine's, on the same bridged weights and batches, f32 on the
CPU, two batches each.

The reparameterisation noise is injected on both sides: a monkeypatched
`reparameterize` feeds the JAX model from a host queue (one array per call,
through jax.pure_callback), and the port's step gets the same arrays as
`eps` (the loop hands each step a generator, which the wrapper drops). The
logged epoch means agree at rtol 1e-3 (the bound of tests/test_torch_engine.py
after the first step); the weights within 2 lr per step, with fewer than
0.1 % of elements beyond 1e-4.

beta = gamma = 10, the train CLI's defaults, as in tests/test_torch_engine.py.
The STN's last layer starts at zero, so step 1 gives the rest of the STN no
gradient and step 2 is Adam's first step there: lr x sign(g) on small
gradients. At gamma 1 the cycle term is too weak to fix those signs, and 2.8 %
of the elements (most of them the STN's) then differ beyond 1e-4 after two
steps; the loop is not the cause (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
import livae_tpu.models.vae as jvae
from livae_tpu.models import init_params
from livae_tpu.train import engine as je
from livae_tpu.train.state import TrainState, make_optimizer as jax_optimizer
from livae_tpu_torch.data.datasets import PairedAdaptiveLatticeDataset, PatchDataset
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils.checkpoint import load_jax_params

PATCH, LATENT, B, STEPS, LR = 32, 8, 4, 2, 1e-3
BETA, GAMMA = 10.0, 10.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eps_queue(monkeypatch):
    queue = []

    def reparameterize(key, mu, logvar):
        eps = jax.pure_callback(lambda _: queue.pop(0),
                                jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                                jax.lax.stop_gradient(mu))
        return mu + eps * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jvae, "reparameterize", reparameterize)
    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    return queue


def _pair(kind):
    jcls, tcls = (jvae.VAE, VAE) if kind == "vae" else (jrvae.RVAE, RVAE)
    jmodel = jcls(latent_dim=LATENT, patch_size=PATCH)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, PATCH, PATCH, 1)))
    model = tcls(LATENT, 1, PATCH, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model, tcls


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _batches(rng, paired):
    """STEPS batches (NHWC numpy): x, or (x, x_rot, angle)."""
    out = []
    for _ in range(STEPS):
        x = rng.random((B, PATCH, PATCH, 1)).astype(np.float32)
        if paired:
            out.append((x, rng.random((B, PATCH, PATCH, 1)).astype(np.float32),
                        rng.uniform(0, 2 * np.pi, B).astype(np.float32)))
        else:
            out.append((x,))  # a tuple's first element is the batch
    return out


def _port_batches(batches):
    return [tuple(_nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in b) for b in batches]


def _injecting(step, eps, seen):
    """The port's step with eps[i] for its i-th call; records the generators."""
    def call(*args, generator):
        seen.append(generator)
        return step(*args, eps=torch.from_numpy(eps[len(seen) - 1]))
    return call


def _close_logs(got: te.MetricLogger, want: je.MetricLogger, prefix: str):
    assert set(got.metrics) == set(want.metrics) and got.metrics
    assert all(k.startswith(prefix) for k in got.metrics)
    for k, v in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=1e-3, atol=2e-4, err_msg=k)


def _close_weights(model, tcls, params):
    ref = tcls(LATENT, 1, PATCH, device="cpu")
    load_jax_params(ref, jax.tree_util.tree_map(np.asarray, params))
    want = ref.state_dict()
    diffs = np.concatenate([(v - want[k]).abs().numpy().ravel()
                            for k, v in model.state_dict().items()])
    assert diffs.max() <= 2 * LR * STEPS
    assert np.mean(diffs > 1e-4) < 1e-3


def test_train_one_epoch_and_evaluate_match(eps_queue, rng):
    """The unpaired loops on the plain VAE."""
    jmodel, params, model, tcls = _pair("vae")
    batches = _batches(rng, paired=False)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(2 * STEPS)]

    eps_queue.extend(eps[STEPS:])
    jlog, tlog = je.MetricLogger(), te.MetricLogger()
    jval = je.evaluate(je.make_eval_step(jmodel), params, [jnp.asarray(b[0]) for b in batches],
                       jax.random.key(3), jlog, BETA, GAMMA)
    seen = []
    tval = te.evaluate(_injecting(te.make_eval_step(model, device="cpu"), eps[STEPS:], seen),
                       _port_batches(batches), 3, tlog, BETA, GAMMA)
    assert set(tval) == set(jval) and all(k.startswith("val_") for k in tval)
    _close_logs(tlog, jlog, "val_")

    tx = jax_optimizer(LR, optimizer="adam")
    state = TrainState.create(params, tx)
    eps_queue.extend(eps[:STEPS])
    jlog, tlog = je.MetricLogger(), te.MetricLogger()
    state = je.train_one_epoch(je.make_train_step(jmodel, tx), state,
                               [tuple(jnp.asarray(a) for a in b) for b in batches],
                               jax.random.key(4), jlog, BETA, GAMMA)
    opt = make_optimizer(model.parameters(), LR, optimizer="adam")
    seen = []
    means = te.train_one_epoch(_injecting(te.make_train_step(model, opt, device="cpu"),
                                          eps[:STEPS], seen),
                               _port_batches(batches), 4, tlog, BETA, GAMMA)
    assert not eps_queue and len(seen) == STEPS
    assert means == {k: v[-1] for k, v in tlog.metrics.items()}
    _close_logs(tlog, jlog, "train_")
    _close_weights(model, tcls, state.params)


def test_train_rvae_one_epoch_and_evaluate_rvae_match(eps_queue, rng):
    jmodel, params, model, tcls = _pair("rvae")
    batches = _batches(rng, paired=True)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(2 * STEPS)]
    jbatches = [tuple(jnp.asarray(a) for a in b) for b in batches]

    eps_queue.extend(eps[STEPS:])
    jlog, tlog = je.MetricLogger(), te.MetricLogger()
    je.evaluate_rvae(je.make_rvae_eval_step(jmodel), params, jbatches, jax.random.key(5),
                     jlog, BETA, GAMMA)
    seen = []
    te.evaluate_rvae(_injecting(te.make_rvae_eval_step(model, device="cpu"), eps[STEPS:], seen),
                     _port_batches(batches), 5, tlog, BETA, GAMMA)
    _close_logs(tlog, jlog, "val_")

    tx = jax_optimizer(LR, optimizer="adamw", weight_decay=1e-5)
    state = TrainState.create(params, tx)
    eps_queue.extend(eps[:STEPS])
    jlog, tlog = je.MetricLogger(), te.MetricLogger()
    state = je.train_rvae_one_epoch(je.make_rvae_train_step(jmodel, tx), state, jbatches,
                                    jax.random.key(6), jlog, BETA, GAMMA)
    opt = make_optimizer(model.parameters(), LR, optimizer="adamw", weight_decay=1e-5)
    seen = []
    te.train_rvae_one_epoch(_injecting(te.make_rvae_train_step(model, opt, device="cpu"),
                                       eps[:STEPS], seen),
                            _port_batches(batches), 6, tlog, BETA, GAMMA)
    assert not eps_queue
    _close_logs(tlog, jlog, "train_")
    _close_weights(model, tcls, state.params)


def test_accumulate_epoch_equals_jax():
    rng = np.random.default_rng(2)
    dicts = [{"loss": rng.random(), "psnr": 10 * rng.random(), "n": float(i)} for i in range(5)]
    want = je._accumulate_epoch([{k: jnp.float32(v) for k, v in d.items()} for d in dicts])
    got = te._accumulate_epoch([{k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}
                                for d in dicts])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    assert te._accumulate_epoch([]) == je._accumulate_epoch([]) == {}


def test_batch_generators_are_seeded_from_seed_and_index():
    """Batch i's generator is a function of (seed, i): the same on every call,
    different across batches and seeds (where the JAX loop takes
    fold_in(key, i))."""
    x = torch.zeros(2, 1, PATCH, PATCH)
    draws = {}
    for seed in (0, 1):
        for rep in range(2):
            seen = []

            def step(x, beta, gamma, generator):
                seen.append(generator.initial_seed())
                return {"loss": torch.rand((), generator=generator)}

            te.evaluate(step, [x, x, x], seed, te.MetricLogger())
            draws[seed, rep] = seen
    assert draws[0, 0] == draws[0, 1] and draws[1, 0] == draws[1, 1]
    assert len(set(draws[0, 0])) == 3 and not set(draws[0, 0]) & set(draws[1, 0])


def test_host_loops_run_over_iter_epoch():
    """Both trainers over the datasets' own iter_epoch batches on the CPU: the
    paired rVAE loop on PairedAdaptiveLatticeDataset, the VAE loop on
    PatchDataset; finite epoch means under the prefixes."""
    frame = synthetic_mos2_frame(size=512, spacing=40.0, seed=1)[0]
    gen = torch.Generator().manual_seed(0)
    paired = PairedAdaptiveLatticeDataset([frame], patch_size=PATCH, padding=8, device="cpu")
    model = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), LR, optimizer="adamw", weight_decay=1e-5)
    log = te.MetricLogger()
    batches = list(paired.iter_epoch(gen, 16))[:2]
    tm = te.train_rvae_one_epoch(te.make_rvae_train_step(model, opt, device="cpu"), batches,
                                 0, log, BETA, GAMMA)
    vm = te.evaluate_rvae(te.make_rvae_eval_step(model, device="cpu"), batches, 1, log)
    patches = PatchDataset([frame], patch_size=PATCH, device="cpu")
    vae = VAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(0))
    vopt = make_optimizer(vae.parameters(), LR, optimizer="adam")
    vbatches = list(patches.iter_epoch(gen, 16))[:2]
    vtm = te.train_one_epoch(te.make_train_step(vae, vopt, device="cpu"), vbatches, 0, log)
    vvm = te.evaluate(te.make_eval_step(vae, device="cpu"), vbatches, 1, log)
    for means, prefix in ((tm, "train_"), (vm, "val_"), (vtm, "train_"), (vvm, "val_")):
        assert means and all(k.startswith(prefix) and np.isfinite(v) for k, v in means.items())
    assert len(log.metrics["train_loss"]) == 2 and len(log.metrics["val_loss"]) == 2
