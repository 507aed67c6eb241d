"""Plain reference of spatial-VAE (Bepler, Zhong, Kelley, Brignole, Berger,
NeurIPS 2019, arXiv:1909.11663; code github.com/tbepler/spatial-VAE) and its
negative ELBO, as functions of a parameter dict keyed by the program's
state-dict names (`encoder.layers`, `decoder.coord_linear`,
`decoder.latent_linear`, `decoder.layers`).

A precision is {"conv": ..., "io": ...}, the other models' shape: the dense
products of the inference net's hidden layers and of the generator's
H -> H and H -> 1 layers compute at "conv" (see common.operands), and the
generator's first pre-activation is stored at "conv" once, after the latent
add; the coordinates, the 2 -> H layer, the latent head, the loss and the
optimizer are float32. The inference net runs on the whole batch, as the
program runs it; the generator runs in blocks of patches, each block's
activations recomputed in the backward (`torch.utils.checkpoint`), so that
a batch of 256 patches at 128 x 128 and width 500 fits beside the program's
freed state.

Departures from the paper, each also the program's: the reconstruction term
is the unit-variance Gaussian's squared error with its constant dropped;
beta multiplies the KL terms; the grid is np.linspace's as upstream's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common as C

BLOCK = 64  # patches a block: its float32 pre-activation at 128 x 128, width 500 is 2.1 GB


def _grid(P: int, device) -> torch.Tensor:
    x0, x1 = np.meshgrid(np.linspace(-1, 1, P), np.linspace(1, -1, P))
    return torch.from_numpy(np.stack([x0.ravel(), x1.ravel()], 1)).float().to(device)


def _dense(h, w, b, precision: str) -> torch.Tensor:
    return C.conv_out(F.linear(*C.operands(h, w, b, precision)), precision)


def _stored(t: torch.Tensor, precision: str) -> torch.Tensor:
    """The first pre-activation as the next layer reads it (bfloat16 kept as
    bfloat16, so its tanh rounds there as the program's does)."""
    return t.to(torch.bfloat16) if precision == "bfloat16" else C.io(t, precision)


def _layers(p: dict, prefix: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    idx = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in p if k.startswith(prefix + ".")})
    return [(p[f"{prefix}.{i}.weight"], p[f"{prefix}.{i}.bias"]) for i in idx]


def _kl(mu, logstd, sigma: float = 1.0) -> torch.Tensor:
    """KL(N(mu, exp(logstd)^2) || N(0, sigma^2)) summed over the group: [B]."""
    return (-logstd + math.log(sigma) + (torch.exp(2 * logstd) + mu ** 2) / (2 * sigma ** 2)
            - 0.5).sum(1)


def _infer(p: dict, x: torch.Tensor, precision: str):
    """The inference net on the whole batch: (mean [B, D], log-std [B, D])."""
    q = _layers(p, "encoder.layers")
    h = x.flatten(1).float()
    for w, b in q[:-1]:
        h = torch.tanh(_dense(h, w, b, precision).float())
    w, b = q[-1]
    out = h @ w.float().T + b.float()
    D = out.shape[1] // 2
    return out[:, :D], out[:, D:]


def _groups(p: dict, D: int) -> tuple[bool, bool]:
    """(rotate, translate) from the widths: D latents, z of them the generator's."""
    wz = p.get("decoder.latent_linear.weight")
    extra = D - (0 if wz is None else wz.shape[1])  # theta (1) and the shift (2)
    return extra in (1, 3), extra >= 2


def _decode_sse(p: dict, lat: torch.Tensor, x: torch.Tensor, precision: str, dx_scale: float,
                rotate: bool, translate: bool) -> torch.Tensor:
    """0.5 x the squared error of the block's reconstruction from its latents
    [b, D], summed over its pixels."""
    B, P = x.shape[0], x.shape[-1]
    coords, k = _grid(P, x.device).expand(B, P * P, 2), 0
    if rotate:
        c, s = torch.cos(lat[:, :1])[:, :, None], torch.sin(lat[:, :1])[:, :, None]
        rot = torch.cat([torch.cat([c, s], 2), torch.cat([-s, c], 2)], 1)  # [b, 2, 2]
        coords, k = torch.bmm(coords, rot), 1
    if translate:
        coords, k = coords + dx_scale * lat[:, None, k:k + 2], k + 2
    h = coords @ p["decoder.coord_linear.weight"].float().T + p["decoder.coord_linear.bias"].float()
    wz = p.get("decoder.latent_linear.weight")
    if wz is not None:
        h = h + (lat[:, k:] @ wz.float().T)[:, None, :]
    h = torch.tanh(_stored(h, precision))
    g = _layers(p, "decoder.layers")
    for w, b in g[:-1]:
        h = torch.tanh(_dense(h, w, b, precision))
    w, b = g[-1]
    y = _dense(h, w, b, precision).float().reshape(B, 1, P, P)
    return 0.5 * torch.sum((y - x) ** 2)


def loss(p, x, eps, precision, loss_cfg: dict, block: int = BLOCK):
    """The negative ELBO of a batch (means over its patches) at precision["conv"],
    and its terms: (total, {"recon_loss", "kld_loss"}). The inference net
    runs on the whole batch, the generator in blocks of patches."""
    prec, B = precision["conv"], x.shape[0]
    mu, logstd = _infer(p, x, prec)
    lat = mu + eps * torch.exp(logstd)
    rotate, translate = _groups(p, mu.shape[1])
    kl, k = 0.0, 0
    if rotate:
        kl, k = _kl(mu[:, :1], logstd[:, :1], loss_cfg["theta_prior"]), 1
    if translate:
        kl, k = kl + _kl(mu[:, k:k + 2], logstd[:, k:k + 2]), k + 2
    kl = (kl + _kl(mu[:, k:], logstd[:, k:])).sum() / B
    rl = sum(checkpoint(_decode_sse, p, lat[i:i + block], x[i:i + block], prec,
                        loss_cfg["dx_scale"], rotate, translate, use_reentrant=False)
             for i in range(0, B, block)) / B
    return rl + loss_cfg["beta"] * kl, {"recon_loss": rl, "kld_loss": kl}
