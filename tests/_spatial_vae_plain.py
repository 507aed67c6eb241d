"""Plain reference of spatial-VAE (Bepler, Zhong, Kelley, Brignole, Berger,
"Explicitly disentangling image content from translation and rotation with
spatial-VAE", NeurIPS 2019, arXiv:1909.11663; code github.com/tbepler/spatial-VAE)
for the CPU tests: its forward pass, its ELBO and the ELBO's terms, as
functions of a parameter dict keyed by the port's state-dict names. Plain
`torch` in float32 with TF32 off; it imports nothing of the port and no JAX.

    q(theta, dx, z | y):  Linear(n, Hq), tanh, Linear(Hq, 2 D) -> mean, log-std
                          of D = [theta, dx (2), z] (the upstream order)
    latents:              mean + eps exp(log-std)
    coordinates:          x' = x R(theta) + dx_scale dx, x on np.linspace's grid
                          (x from -1 to 1 along a row, y from 1 to -1 down
                          the columns), R = [[cos, sin], [-sin, cos]]
    p(y | x', z):         tanh(x' W_c^T + b_c + z W_z^T), (tanh(h W^T + b)) x
                          (L - 1), h W_o^T + b_o
    -ELBO:                0.5 sum (y_hat - y)^2 + KL(z) + KL(theta) + KL(dx),
                          each a mean over the batch

Departures from the paper and its code, each also the port's:
- The reconstruction term is the unit-variance Gaussian's, with its constant
  dropped (the upstream particle script's squared error); the patches are
  min-max normalised, not standardised.
- beta multiplies the KL terms (1 in the paper).
- The upstream code holds the first hidden layers in one Sequential; the
  names here are the port's (`encoder.layers`, `decoder.coord_linear`,
  `decoder.latent_linear`, `decoder.layers`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def grid(P: int) -> torch.Tensor:
    """[P * P, 2] (x, y) of the pixels in row-major order, as the upstream code's meshgrid."""
    x0, x1 = np.meshgrid(np.linspace(-1, 1, P), np.linspace(1, -1, P))
    return torch.from_numpy(np.stack([x0.ravel(), x1.ravel()], 1)).float()


def _layers(p: dict, prefix: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The (weight, bias) of `prefix`.<i> in order of i."""
    idx = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in p if k.startswith(prefix + ".")})
    return [(p[f"{prefix}.{i}.weight"], p[f"{prefix}.{i}.bias"]) for i in idx]


def infer(p: dict, y: torch.Tensor):
    """y [B, 1, P, P] -> (mean [B, D], log-std [B, D])."""
    layers = _layers(p, "encoder.layers")
    h = y.flatten(1)
    for w, b in layers[:-1]:
        h = torch.tanh(h @ w.T + b)
    w, b = layers[-1]
    out = h @ w.T + b
    D = out.shape[1] // 2
    return out[:, :D], out[:, D:]


def generate(p: dict, coords: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """coords [B, n, 2], z [B, z] -> [B, n]."""
    h = coords @ p["decoder.coord_linear.weight"].T + p["decoder.coord_linear.bias"]
    if "decoder.latent_linear.weight" in p:
        h = h + (z @ p["decoder.latent_linear.weight"].T)[:, None, :]
    h = torch.tanh(h)
    layers = _layers(p, "decoder.layers")
    for w, b in layers[:-1]:
        h = torch.tanh(h @ w.T + b)
    w, b = layers[-1]
    return (h @ w.T + b)[..., 0]


def forward(p: dict, y: torch.Tensor, eps: torch.Tensor, rotate: bool = True,
            translate: bool = True, dx_scale: float = 0.1) -> dict:
    """The reconstruction [B, 1, P, P] and each latent group's mean and log-std
    ("z", "theta", "dx"; a group left out is absent)."""
    B, P = y.shape[0], y.shape[-1]
    mu, logstd = infer(p, y)
    lat = mu + eps * torch.exp(logstd)
    out, k = {}, 0
    coords = grid(P).to(y.device).expand(B, P * P, 2)
    if rotate:
        theta = lat[:, 0]
        c, s = torch.cos(theta), torch.sin(theta)
        rot = torch.stack([torch.stack([c, s], 1), torch.stack([-s, c], 1)], 1)  # [B, 2, 2]
        coords = torch.bmm(coords, rot)
        out["theta"] = (mu[:, :1], logstd[:, :1])
        k = 1
    if translate:
        coords = coords + dx_scale * lat[:, None, k:k + 2]
        out["dx"] = (mu[:, k:k + 2], logstd[:, k:k + 2])
        k += 2
    out["z"] = (mu[:, k:], logstd[:, k:])
    out["recon"] = generate(p, coords, lat[:, k:]).reshape(B, 1, P, P)
    return out


def _kl(mu, logstd, sigma: float = 1.0) -> torch.Tensor:
    """KL(N(mu, exp(logstd)^2) || N(0, sigma^2)) summed over the group, mean over the batch."""
    std = torch.exp(logstd)
    kl = -logstd + math.log(sigma) + (std ** 2 + mu ** 2) / (2 * sigma ** 2) - 0.5
    return kl.sum(1).mean()


def elbo(p: dict, y: torch.Tensor, eps: torch.Tensor, beta: float = 1.0,
         theta_prior: float = math.pi, rotate: bool = True, translate: bool = True,
         dx_scale: float = 0.1):
    """(-ELBO, {"recon_loss", "kl_z", "kl_theta", "kl_dx", "kld_loss"})."""
    out = forward(p, y, eps, rotate, translate, dx_scale)
    rl = 0.5 * torch.sum((out["recon"] - y) ** 2) / y.shape[0]
    zero = torch.zeros(())
    terms = {"recon_loss": rl, "kl_z": _kl(*out["z"]),
             "kl_theta": _kl(*out["theta"], theta_prior) if rotate else zero,
             "kl_dx": _kl(*out["dx"]) if translate else zero}
    terms["kld_loss"] = terms["kl_z"] + terms["kl_theta"] + terms["kl_dx"]
    return rl + beta * terms["kld_loss"], terms
