"""The port's plain VAE, generic train step and fused VAE paths against
livae_tpu's, through bridged weights, on the CPU at f32.

The JAX ConvTranspose is an input-dilated convolution with a flipped kernel;
the bridge's `convT` kind does not flip, and `nn.ConvTranspose2d` flips by
definition, so the outputs agree: held here at 2e-4 (f32 convolutions summed
in another order), the bound of tests/test_torch_models.py. The
reparameterisation noise is injected on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu.models.rvae as jrvae
import livae_tpu.models.vae as jvae
from livae_tpu.data.pipeline import AugmentConfig, _sample_aug, pad_frames
from livae_tpu.models import init_params
from livae_tpu.train import engine as je
from livae_tpu.train.state import TrainState, make_optimizer as jax_optimizer
from livae_tpu_torch.data.pipeline import AugmentConfig as TorchAugmentConfig, PairedDraws
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.train import engine as te
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils.checkpoint import load_jax_params

ATOL = 2e-4
SIZES = [(32, 8), (64, 16)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    t = t.detach().float().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


def _pair(module, port_cls, patch, latent):
    cls = jvae.VAE if module is jvae else jrvae.RVAE
    jmodel = cls(latent_dim=latent, patch_size=patch)
    params = init_params(jmodel, {"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, patch, patch, 1)))
    tmodel = port_cls(latent, 1, patch, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("patch,latent", SIZES)
def test_vae_forward_encode_decode_match(rng, monkeypatch, patch, latent):
    jmodel, params, tmodel = _pair(jvae, VAE, patch, latent)
    B = 4
    x = rng.random((B, patch, patch, 1)).astype(np.float32)
    eps = rng.standard_normal((B, latent)).astype(np.float32)
    z = rng.standard_normal((B, latent)).astype(np.float32)
    monkeypatch.setattr(jvae, "reparameterize",
                        lambda key, mu, logvar: mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar))
    want = jmodel.apply(params, jnp.asarray(x), rngs={"sample": jax.random.key(2)})
    want_enc = jmodel.apply(params, jnp.asarray(x), method="encode")
    want_dec = jmodel.apply(params, jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = tmodel(_nchw(x), eps=torch.from_numpy(eps))
        got_enc = tmodel.encode(_nchw(x))
        got_dec = tmodel.decode(torch.from_numpy(z))
    assert len(got) == len(want) == 3 and len(got_enc) == 2
    for name, g, w in zip(("recon", "mu", "logvar"), got, want):
        assert _nhwc(g).shape == np.asarray(w).shape, name
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)
    for name, g, w in zip(("mu", "logvar"), got_enc, want_enc):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)
    np.testing.assert_allclose(_nhwc(got_dec), np.asarray(want_dec), atol=ATOL)


def test_vae_state_dict_keys_and_init():
    m = VAE(8, 1, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    keys = set(m.state_dict())
    want = {f"encoder.conv_layers.{i}" for i in (0, 2, 4, 6)} | {
        "encoder.fc_mu", "encoder.fc_logvar", "decoder.fc"} | {
        f"decoder.deconv_layers.{i}" for i in (0, 2, 4, 6)}
    assert keys == {f"{k}.{p}" for k in want for p in ("weight", "bias")}
    # ConvTranspose2d weights are [in, out, k, k]; torch's default bound uses out * k * k
    w = m.decoder.deconv_layers[0].weight.detach()
    assert tuple(w.shape) == (256, 128, 4, 4)
    assert float(w.abs().max()) <= 1.0 / np.sqrt(128 * 16)
    again = VAE(8, 1, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in m.state_dict().items())


def test_vae_bfloat16_policy(rng):
    m = VAE(8, 1, 32, "bfloat16", device="cpu", generator=torch.Generator().manual_seed(0))
    x = _nchw(rng.random((2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        recon, mu, logvar = m(x, generator=torch.Generator().manual_seed(1))
    for t in (recon, mu, logvar):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    ref = VAE(8, 1, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mu32, _ = ref.encode(x)
    np.testing.assert_allclose(mu.numpy(), mu32.numpy(), atol=0.05)  # bf16 convolutions


@pytest.fixture
def eps_queue(monkeypatch):
    """Host-fed noise for both JAX models (one pop per call)."""
    queue = []

    def reparameterize(key, mu, logvar):
        eps = jax.pure_callback(lambda _: queue.pop(0),
                                jax.ShapeDtypeStruct(mu.shape, mu.dtype),
                                jax.lax.stop_gradient(mu))
        return mu + eps * jnp.exp(0.5 * logvar)

    monkeypatch.setattr(jvae, "reparameterize", reparameterize)
    monkeypatch.setattr(jrvae, "reparameterize", reparameterize)
    return queue


@pytest.mark.parametrize("kind", ["vae", "rvae", "rvae_diversity_canonical"])
def test_three_generic_adam_steps_match(eps_queue, rng, kind):
    """Three Adam steps of the generic train step against
    livae_tpu.train.engine.make_train_step: the VAE (3 outputs), the RVAE (5
    outputs) and the RVAE with the diversity term and the canonical loss.
    Metrics at 2e-4 on step 1, rtol 1e-3 after; weights within 2 lr per step
    with fewer than 0.1 % of elements off by more than 1e-4 (the bounds of
    tests/test_torch_engine.py)."""
    patch, latent, B = 32, 8, 4
    module, cls = (jvae, VAE) if kind == "vae" else (jrvae, RVAE)
    jmodel, params, model = _pair(module, cls, patch, latent)
    opts = (dict(use_diversity=True, canonical_weight=0.2)
            if kind == "rvae_diversity_canonical" else {})
    tx = jax_optimizer(1e-3, optimizer="adam")
    state = TrainState.create(params, tx)
    jstep = je.make_train_step(jmodel, tx, grad_max_norm=5.0, **opts)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adam")
    tstep = te.make_train_step(model, opt, grad_max_norm=5.0, device="cpu", **opts)
    jeval = je.make_eval_step(jmodel, **opts)
    teval = te.make_eval_step(model, device="cpu", **opts)
    beta, gamma = 1.0, 0.5

    for i in range(3):
        x = rng.random((B, patch, patch, 1)).astype(np.float32)
        eps = rng.standard_normal((B, latent)).astype(np.float32)
        if i == 0:  # the eval step on the same weights and batch
            eps_queue.append(eps)
            want = jeval(params, jnp.asarray(x), jax.random.key(9), beta, gamma)
            got = te.metrics_to_host(teval(_nchw(x), beta, gamma, eps=torch.from_numpy(eps)))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-4, rtol=2e-4,
                                           err_msg=f"eval {k}")
        eps_queue.append(eps)
        state, jm = jstep(state, jnp.asarray(x), jax.random.key(i), beta, gamma)
        tm = te.metrics_to_host(tstep(_nchw(x), beta, gamma, eps=torch.from_numpy(eps)))
        assert set(tm) == set(jm)
        for k in jm:
            tol = dict(atol=2e-4, rtol=2e-4) if i == 0 else dict(atol=2e-4, rtol=1e-3)
            np.testing.assert_allclose(tm[k], np.asarray(jm[k]), err_msg=f"step {i} {k}", **tol)
    assert not eps_queue

    ref = cls(latent, 1, patch, device="cpu")
    load_jax_params(ref, jax.tree_util.tree_map(np.asarray, state.params))
    jstate = {k: v.numpy() for k, v in ref.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in model.state_dict().items()])
    assert diffs.max() <= 2 * 1e-3 * 3
    assert np.mean(diffs > 1e-4) < 1e-3


# --- the fused VAE paths (what train_vae runs) --------------------------------

PATCH, LATENT, PAD = 32, 8, 8
MARGIN = (PATCH + 2 * PAD + 16) // 2 + 8


@pytest.fixture
def site_table(rng):
    """Two random frames and 23 sites: with batch 4 and 11 val sites the val
    set is two full batches and a tail of 3."""
    N, H, W, n = 2, 120, 140, 23
    raw = rng.random((N, H, W)).astype(np.float32)
    coords = np.stack([rng.uniform(20, H - 20, n), rng.uniform(20, W - 20, n)],
                      axis=1).astype(np.float32)
    img_idx = rng.integers(0, N, n).astype(np.int32)
    jtable = (pad_frames(jnp.asarray(raw), MARGIN), jnp.asarray(img_idx), jnp.asarray(coords),
              MARGIN)
    ttable = (torch.nn.functional.pad(torch.from_numpy(raw), (MARGIN,) * 4),
              torch.from_numpy(img_idx).long(), torch.from_numpy(coords), MARGIN)
    return jtable, ttable


@pytest.mark.parametrize("kind", ["vae", "rvae_canonical"])
def test_evaluate_fused_matches(eps_queue, site_table, rng, kind):
    """`evaluate_fused` over `make_fused_eval` against livae_tpu's, on 11 val
    sites at batch 4: two full batches and a ragged tail of 3, each batch
    weighing the same. Every metric at 2e-4 (the model parity bound)."""
    module, cls = (jvae, VAE) if kind == "vae" else (jrvae, RVAE)
    jmodel, params, model = _pair(module, cls, PATCH, LATENT)
    jtable, ttable = site_table
    B, val_idx = 4, rng.permutation(23)[:11]
    opts = dict(patch_size=PATCH, padding=PAD, margin=MARGIN,
                canonical_weight=0.2 if kind == "rvae_canonical" else 0.0)
    eps = [rng.standard_normal((b, LATENT)).astype(np.float32) for b in (B, B, 3)]
    eps_queue.extend(eps)
    jeval = je.make_fused_eval(jmodel, **opts)
    want = je.evaluate_fused(jeval, jeval, params, jtable, val_idx, B, jax.random.key(5),
                             beta=1.0, gamma=0.5)
    assert not eps_queue

    teval = te.make_fused_eval(model, device="cpu", **opts)
    feed = [torch.from_numpy(e) for e in eps]

    def with_eps(fp, img_idx, coords, idx_batches, *rest):  # evaluate_fused passes no eps
        return teval(fp, img_idx, coords, idx_batches, *rest,
                     eps=[feed.pop(0) for _ in idx_batches])

    logger = te.MetricLogger()
    got = te.evaluate_fused(with_eps, ttable, val_idx, B, None, logger, beta=1.0, gamma=0.5)
    assert not feed and set(got) == set(want) and logger.get_averages() == got
    assert ("val_canonical_psnr" in got) == (kind == "rvae_canonical")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("rotation", [False, True], ids=["folded", "rotation"])
def test_fused_vae_train_steps_match(eps_queue, site_table, rng, rotation):
    """Three steps of `make_fused_vae_train_step` (extraction with the
    augmentation, Adam, clip 5) against livae_tpu's in one call: the draws are
    derived as the JAX step derives them from its key (fold_in(key, i) ->
    (ke, ks); `_sample_aug(ke)`) and handed to the port with the same eps. The
    step-mean metrics at rtol 1e-3 and the weights within 2 lr per step, with
    fewer than 0.1 % of elements off by more than 1e-4 where the batches are
    bit-equal (the bounds of tests/test_torch_engine.py; steps 2 and 3 start
    from weights that differ by f32 rounding) and fewer than 0.5 % with the
    rotation."""
    jmodel, params, model = _pair(jvae, VAE, PATCH, LATENT)
    jtable, ttable = site_table
    B, S = 4, 3
    cfg = AugmentConfig(rotation=rotation)
    idx = rng.permutation(23)[: S * B].reshape(S, B).astype(np.int32)
    key = jax.random.key(7)
    opts = dict(patch_size=PATCH, padding=PAD, margin=MARGIN, grad_max_norm=5.0)
    eps = [rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(S)]
    eps_queue.extend(eps)
    tx = jax_optimizer(1e-3, optimizer="adam")
    jstep = je.make_fused_vae_train_step(jmodel, tx, cfg=cfg, **opts)
    # the step donates its state's buffers: give it copies
    state = TrainState.create(jax.tree_util.tree_map(jnp.array, params), tx)
    state, want = jstep(state, *jtable[:3], jnp.asarray(idx), key, 1.0, 0.0)
    want = je.metrics_to_host(want)
    assert not eps_queue

    draws = []
    for i in range(S):
        ke, _ = jax.random.split(jax.random.fold_in(key, i))
        scale, angle, fh, fv, jy, jx = (np.array(v) for v in _sample_aug(ke, B, cfg))
        t = torch.from_numpy
        draws.append(PairedDraws(t(scale), t(fh), t(fv), t(jy).long(), t(jx).long(), t(angle)))
    ttx = TorchAugmentConfig(rotation=rotation)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adam")
    tstep = te.make_fused_vae_train_step(model, opt, cfg=ttx, device="cpu", **opts)
    got = te.metrics_to_host(tstep(*ttable[:3], torch.from_numpy(idx).long(), None, 1.0, 0.0,
                                   draws=draws, eps=[torch.from_numpy(e) for e in eps]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=1e-3, err_msg=k)

    ref = VAE(LATENT, 1, PATCH, device="cpu")
    load_jax_params(ref, jax.tree_util.tree_map(np.asarray, state.params))
    jstate = {k: v.numpy() for k, v in ref.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in model.state_dict().items()])
    assert diffs.max() <= 2 * 1e-3 * 3
    # With the rotation the two batches differ by the extraction's 1e-5, so more
    # of the decoder's near-zero gradients take their first Adam steps (size lr
    # whatever the gradient's size) the other way: 0.3 % of elements here.
    assert np.mean(diffs > 1e-4) < (5e-3 if rotation else 1e-3)
