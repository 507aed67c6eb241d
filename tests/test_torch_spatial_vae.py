"""spatial-VAE in the port (models/spatial_vae.py, losses.spatial_vae_loss,
the generic fused step and eval, train_vae --arch spatial) against its plain
reference (tests/_spatial_vae_plain.py), on the CPU at patch 16, width 32,
z = 2, on seeded random weights.

Tolerances: the port and the reference compute in float32 with different
orders of operations (one baddbmm against a product and a broadcast add for
the first layer, the grid's rotation elementwise against a bmm, the loss
through the engine's dispatch), so values agree to a few float32 ulps of
their magnitude; sums over the 256 pixels and the batch widen that to about
1e-5 relative.
"""

import math

import numpy as np
import pytest
import torch

from livae_tpu_torch.data.pipeline import AugmentConfig, PairedDraws, extract_batch
from livae_tpu_torch.losses import spatial_vae_loss
from livae_tpu_torch.models.spatial_vae import SpatialOutputs, SpatialVAE, coordinate_grid
from livae_tpu_torch.scripts import train_vae
from livae_tpu_torch.train import engine
from livae_tpu_torch.utils import checkpoint as tc

import _spatial_vae_plain as plain

P, H, Z, B = 16, 32, 2, 5
FLAGS = [(True, True), (True, False), (False, True), (False, False)]
IDS = ["rot+dx", "rot", "dx", "neither"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(rotate=True, translate=True, seed=0, **kw):
    return SpatialVAE(Z, P, H, q_hidden_dim=H, rotate=rotate, translate=translate,
                      device="cpu", generator=torch.Generator().manual_seed(seed), **kw)


def _inputs(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, 1, P, P), generator=g), torch.randn((B, model.noise_dim), generator=g)


def _params(model):
    return {k: v.detach().clone().requires_grad_() for k, v in model.state_dict().items()}


def test_grid_is_the_upstream_meshgrid_and_made_once():
    got = coordinate_grid(P, torch.device("cpu"))
    torch.testing.assert_close(got, plain.grid(P), atol=1e-7, rtol=0)  # linspace's rounding
    assert coordinate_grid(P, torch.device("cpu")) is got
    # exactly symmetric: a quarter turn maps grid points onto grid points
    assert torch.equal(got[:, 0].reshape(P, P).flip(1), -got[:, 0].reshape(P, P))


@pytest.mark.parametrize("rotate,translate", FLAGS, ids=IDS)
def test_forward_matches_the_plain_reference(rotate, translate):
    model = _model(rotate, translate)
    x, eps = _inputs(model)
    out = model(x, eps)
    want = plain.forward(_params(model), x, eps, rotate, translate)
    assert isinstance(out, SpatialOutputs) and model.noise_dim == Z + rotate + 2 * translate
    torch.testing.assert_close(out.recon, want["recon"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close((out.mu, out.logstd), want["z"], atol=1e-6, rtol=1e-5)
    assert (out.theta_mu is None) == (not rotate) and (out.dx_mu is None) == (not translate)
    if rotate:
        torch.testing.assert_close((out.theta_mu, out.theta_logstd), want["theta"])
    if translate:
        torch.testing.assert_close((out.dx_mu, out.dx_logstd), want["dx"])


@pytest.mark.parametrize("rotate,translate", FLAGS, ids=IDS)
def test_loss_terms_and_every_gradient_match(rotate, translate):
    """Every term of the ELBO at 1e-5 relative; every leaf's gradient within
    1e-4 of the leaf's largest element (sums over 256 pixels of products
    that round differently)."""
    model = _model(rotate, translate, theta_prior=2.0)
    x, eps = _inputs(model)
    beta = 0.7
    out = model(x, eps)
    total, rl, kl, terms = spatial_vae_loss(out.recon, x, out.mu, out.logstd, out.theta_mu,
                                            out.theta_logstd, out.dx_mu, out.dx_logstd,
                                            out.theta_prior, beta)
    p = _params(model)
    want, wterms = plain.elbo(p, x, eps, beta, 2.0, rotate, translate)
    got = {"recon_loss": rl, "kld_loss": kl, **terms}
    assert set(got) == set(wterms)
    for k in wterms:
        torch.testing.assert_close(got[k], wterms[k], atol=1e-6, rtol=1e-5, msg=k)
    torch.testing.assert_close(total, want, atol=1e-6, rtol=1e-5)
    # the engine's dispatch gives the same total and terms
    e_total, aux = engine._generic_terms(out, x, beta, 0.0, False)
    torch.testing.assert_close((e_total, aux["rl"], aux["kl"]), (total, rl, kl))

    grads = dict(zip(dict(model.named_parameters()),
                     torch.autograd.grad(total, list(model.parameters()))))
    wgrads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    assert set(grads) == set(wgrads)
    for k, g in wgrads.items():
        assert g.abs().max() > 0, k  # theta and dx reach every leaf through the coordinates
        torch.testing.assert_close(grads[k], g, atol=1e-4 * g.abs().max().item(), rtol=1e-4,
                                   msg=k)


def test_decoder_is_equivariant_to_a_quarter_turn():
    """Decoding at theta = pi/2 equals decoding at theta = 0 on the grid
    turned a quarter (a clockwise rot90 of the image), to float32 rounding:
    cos(pi/2) rounds to 4.4e-8, not 0."""
    model = _model()
    z = torch.randn((3, Z), generator=torch.Generator().manual_seed(4))
    dec = {}
    with torch.no_grad():
        for name, t in (("zero", 0.0), ("quarter", math.pi / 2)):
            coords = model.coordinates(torch.full((3, 1), t), None, 3, torch.device("cpu"))
            dec[name] = model.decoder(coords, z).reshape(3, P, P)
    torch.testing.assert_close(dec["quarter"], torch.rot90(dec["zero"], -1, (1, 2)),
                               atol=1e-6, rtol=1e-6)
    assert not torch.allclose(dec["quarter"], dec["zero"], atol=1e-3)


# --- the fused path ---

PAD = 4
MARGIN = (P + 2 * PAD + 16) // 2 + 8


def _site_table(n=12):
    g = np.random.default_rng(3)
    raw = g.random((2, 80, 90)).astype(np.float32)
    coords = np.stack([g.uniform(20, 60, n), g.uniform(20, 70, n)], 1).astype(np.float32)
    return (torch.nn.functional.pad(torch.from_numpy(raw), (MARGIN,) * 4),
            torch.from_numpy(g.integers(0, 2, n)).long(), torch.from_numpy(coords))


def _draws(seed=5, n=B):
    g = torch.Generator().manual_seed(seed)
    return PairedDraws(0.9 + 0.2 * torch.rand(n, generator=g), torch.rand(n, generator=g) < 0.5,
                       torch.rand(n, generator=g) < 0.5, torch.randint(-4, 5, (n,), generator=g),
                       torch.randint(-4, 5, (n,), generator=g), torch.rand(n, generator=g))


def test_fused_row_equals_a_plain_step():
    """One row of `make_fused_vae_train_step` (eager on the CPU: the row
    `_RowGraphs` captures on the card) against a plain step of the same
    draws and noise: the port's extraction, the plain reference's loss,
    autograd, the global clip at 5 and torch's Adam. Metrics at 1e-5
    relative; weights within 1e-6 of the step's 1e-3 (Adam's first step
    moves every element by about lr)."""
    model = _model()
    w0 = _params(model)
    cfg = AugmentConfig()
    table = _site_table()
    idx = torch.tensor([[0, 3, 5, 7, 11]])
    d, eps = _draws(), torch.randn((B, model.noise_dim), generator=torch.Generator().manual_seed(6))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = engine.make_fused_vae_train_step(model, opt, patch_size=P, padding=PAD, cfg=cfg,
                                            margin=MARGIN, grad_max_norm=5.0, device="cpu")
    got = step(*table, idx, None, 1.0, 0.0, draws=[d], eps=[eps])

    x = extract_batch(table[0], table[1][idx[0]], table[2][idx[0]], P, PAD, margin=MARGIN,
                      cfg=cfg, draws=d)
    loss, terms = plain.elbo(w0, x, eps)
    grads = torch.autograd.grad(loss, list(w0.values()))
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = min(1.0, 5.0 / norm.item())
    ref_opt = torch.optim.Adam(list(w0.values()), lr=1e-3)
    for p, g in zip(w0.values(), grads):
        p.grad = g * scale
    ref_opt.step()
    want = {"loss": loss, "recon_loss": terms["recon_loss"], "kld_loss": terms["kld_loss"],
            "cycle_loss": torch.zeros(()), "grad_norm": torch.clamp(norm, max=5.0)}
    assert set(got) == set(engine.FUSED_VAE_METRIC_NAMES)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v.detach(), atol=1e-6, rtol=1e-5, msg=k)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, w0[k].detach(), atol=1e-6, rtol=0, msg=k)


def test_fused_eval_reports_the_elbo_and_the_angle_spread():
    model = _model()
    table = _site_table()
    ev = engine.make_fused_eval(model, patch_size=P, padding=PAD, margin=MARGIN, device="cpu")
    eps = torch.randn((4, model.noise_dim), generator=torch.Generator().manual_seed(2))
    got = ev(*table, torch.tensor([[1, 2, 4, 8]]), None, 1.0, 0.0, eps=[eps])
    x = extract_batch(table[0], table[1][[1, 2, 4, 8]], table[2][[1, 2, 4, 8]], P, PAD,
                      margin=MARGIN)
    want, terms = plain.elbo(_params(model), x, eps)
    torch.testing.assert_close(got["loss"][0], want.detach(), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(got["recon_loss"][0], terms["recon_loss"].detach(),
                               atol=1e-6, rtol=1e-5)
    assert {"psnr", "ssim", "rotation_std", "latent_std"} <= set(got)


def test_train_vae_arch_spatial_one_epoch_and_checkpoint(tmp_path, capsys):
    """`train_vae --arch spatial` on one synthetic frame (512 pixels: a
    smaller frame's lattice gives one site), one epoch; the checkpoint loads
    back bit for bit into a fresh model."""
    ckpt = tmp_path / "s" / "spatial.pt"
    args = train_vae.build_argparser().parse_args(
        ["--cpu", "--no-amp", "--synthetic", "1", "--synthetic-size", "512", "--arch", "spatial",
         "--patch-size", str(P), "--padding", "8", "--batch-size", "64", "--latent-dim", str(Z),
         "--p-hidden-dim", str(H), "--q-hidden-dim", str(H), "--theta-prior", "1.5",
         "--epochs", "1", "--no-tensorboard", "--checkpoint", str(ckpt)])
    out = train_vae.run_training(args)
    model = out["model"]
    assert isinstance(model, SpatialVAE) and model.theta_prior == 1.5
    metrics = out["epochs"][0]["metrics"]
    assert all(np.isfinite(v) for v in metrics.values())
    assert {"train_loss", "train_kld_loss", "val_loss", "val_rotation_std"} <= set(metrics)
    assert "SpatialVAE: " in capsys.readouterr().out
    final = ckpt.with_name("spatial_final.pt")
    state, payload = tc.load_reference_checkpoint(final)
    assert payload["args"]["arch"] == "spatial" and payload["args"]["dx_scale"] == 0.1
    live = model.state_dict()
    assert set(state) == set(live) and all(torch.equal(state[k], live[k].cpu()) for k in live)
    fresh = _model(seed=9)
    fresh.load_state_dict(state, strict=True)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in state.items())
    with pytest.raises(ValueError, match="no JAX counterpart"):
        tc.model_spec(fresh)


def test_spatial_refuses_a_model_axis():
    args = train_vae.build_argparser().parse_args(
        ["--cpu", "--arch", "spatial", "--num-devices", "2", "--model-parallel", "2"])
    with pytest.raises(SystemExit, match="data-parallel only"):
        train_vae.run_training(args)
