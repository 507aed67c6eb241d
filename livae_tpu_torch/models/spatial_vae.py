"""spatial-VAE: the coordinate-decoder rotationally invariant VAE (Bepler,
Zhong, Kelley, Brignole, Berger, "Explicitly disentangling image content from
translation and rotation with spatial-VAE", NeurIPS 2019, arXiv:1909.11663;
the model of AtomAI's rVAE).

An MLP inference net maps the flattened patch to the mean and log-std of
D = z + rotate + 2 translate latents: the angle theta first, then the shift
dx, then the z content latents (the upstream code's order). The generator
decodes every pixel of the patch from its coordinate on a grid over
[-1, 1]^2, turned by theta and shifted by dx * dx_scale:

    x' = R(theta) x + dx_scale dx
    h1 = tanh(W_c x' + b_c + W_z z)
    h  = tanh(W h + b)                      (num_layers - 1 times, width H)
    y  = W_o h + b_o

Module names follow the upstream code: `encoder.layers` (its
InferenceNetwork), `decoder.coord_linear`, `decoder.latent_linear` (no bias)
and `decoder.layers` (its SpatialGenerator).

Mixed precision (`compute_dtype`): the n -> Hq, H -> H and H -> 1 products
take operands in the compute dtype (float32 accumulation). The coordinates,
the 2 -> H layer's arithmetic and the latent head stay float32: rounding x'
to bfloat16 would move a pixel by up to half a grid step at 128 pixels a
side. The first layer's pre-activation is rounded to the compute dtype once,
after the latent add.

Spans (`tracing`): `coords` (the grid's rotation and shift) and `decode`
(the coordinate MLP) open inside the forward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..tracing import span
from .vae import _dtype

__all__ = ["SpatialOutputs", "SpatialVAE", "coordinate_grid"]

_GRID: dict = {}


def coordinate_grid(P: int, device: torch.device) -> torch.Tensor:
    """[P * P, 2] float32 (x, y) of the pixels in row-major order: x from -1
    to 1 along a row, y from 1 to -1 down the columns (the upstream code's
    meshgrid), exactly symmetric about 0. Made once per (P, device): a copy
    from the host on every call would hold up the host loop, and a CUDA
    graph cannot capture one."""
    key = (P, str(device))
    grid = _GRID.get(key)
    if grid is None:
        axis = (2.0 * torch.arange(P, dtype=torch.float64) - (P - 1)) / (P - 1)
        y, x = torch.meshgrid(-axis, axis, indexing="ij")
        grid = _GRID[key] = torch.stack([x.reshape(-1), y.reshape(-1)], 1).float().to(device)
    return grid


class SpatialOutputs(NamedTuple):
    """The forward's outputs: the reconstruction [B, 1, P, P] (float32) and
    each latent group's mean and log-std, float32; theta's [B, 1] and dx's
    [B, 2] are None where the model does not infer them. `theta_prior` is
    the std of theta's prior."""

    recon: torch.Tensor
    mu: torch.Tensor
    logstd: torch.Tensor
    theta_mu: torch.Tensor | None
    theta_logstd: torch.Tensor | None
    dx_mu: torch.Tensor | None
    dx_logstd: torch.Tensor | None
    theta_prior: float


class InferenceNet(nn.Module):
    """Linear(n, Hq), tanh, (Linear(Hq, Hq), tanh) x (num_layers - 1),
    Linear(Hq, 2 D) -> (mean [B, D], log-std [B, D]), float32."""

    def __init__(self, n: int, out_dim: int, hidden_dim: int, num_layers: int,
                 compute_dtype: str | None):
        super().__init__()
        self.compute_dtype = compute_dtype
        layers: list[nn.Module] = []
        d = n
        for _ in range(num_layers):
            layers += [nn.Linear(d, hidden_dim), nn.Tanh()]
            d = hidden_dim
        layers.append(nn.Linear(d, 2 * out_dim))
        self.layers = nn.Sequential(*layers)
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor):
        cd = _dtype(self.compute_dtype)
        h = x.flatten(1)
        for lin in list(self.layers)[:-1:2]:
            h = torch.tanh(_linear(lin, h, cd).float())
        out = self.layers[-1](h)
        return out[:, :self.out_dim], out[:, self.out_dim:]


class SpatialGenerator(nn.Module):
    """The coordinate MLP: (coordinates [B, n, 2], z [B, z]) -> [B, n] float32."""

    def __init__(self, latent_dim: int, hidden_dim: int, num_layers: int,
                 compute_dtype: str | None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.coord_linear = nn.Linear(2, hidden_dim)
        self.latent_linear = nn.Linear(latent_dim, hidden_dim, bias=False) if latent_dim else None
        layers: list[nn.Module] = [nn.Tanh()]
        for _ in range(num_layers - 1):
            layers += [nn.Linear(hidden_dim, hidden_dim), nn.Tanh()]
        layers.append(nn.Linear(hidden_dim, 1))
        self.layers = nn.Sequential(*layers)

    def forward(self, coords: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        cd = _dtype(self.compute_dtype)
        B, H = coords.shape[0], self.coord_linear.out_features
        bias = self.coord_linear.bias.expand(B, H)
        if self.latent_linear is not None:
            bias = bias + self.latent_linear(z)
        # float32 x' W_c^T + b_c + W_z z in one pass, rounded once
        h = torch.baddbmm(bias[:, None, :], coords, self.coord_linear.weight.t().expand(B, 2, H))
        h = torch.tanh(h if cd is None else h.to(cd))
        for lin in list(self.layers)[1:-1:2]:
            h = torch.tanh(_linear(lin, h, cd))
        return _linear(self.layers[-1], h, cd).float()[..., 0]


def _linear(lin: nn.Linear, h: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """lin(h) with input, weight and bias cast to the compute dtype."""
    w, b = lin.weight, lin.bias
    if cd is not None:
        h, w, b = h.to(cd), w.to(cd), b.to(cd)
    return F.linear(h, w, b)


class SpatialVAE(nn.Module):
    """spatial-VAE; forward(x [B, 1, P, P], eps [B, noise_dim] or None,
    generator) -> SpatialOutputs. The noise is drawn from `generator` (on
    x's device) unless given. Built on `device` (CUDA unless `device="cpu"`),
    initialised from `generator` (a CPU torch.Generator) at PyTorch's default
    bounds."""

    def __init__(self, latent_dim: int = 2, patch_size: int = 128, hidden_dim: int = 500,
                 num_layers: int = 2, q_hidden_dim: int = 500, q_num_layers: int = 1,
                 rotate: bool = True, translate: bool = True, theta_prior: float = math.pi,
                 dx_scale: float = 0.1, compute_dtype: str | None = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.latent_dim, self.patch_size = latent_dim, patch_size
        self.rotate, self.translate = rotate, translate
        self.theta_prior, self.dx_scale = float(theta_prior), float(dx_scale)
        self.compute_dtype = compute_dtype
        self.noise_dim = latent_dim + int(rotate) + 2 * int(translate)
        with torch.device("meta"):
            self.encoder = InferenceNet(patch_size * patch_size, self.noise_dim, q_hidden_dim,
                                        q_num_layers, compute_dtype)
            self.decoder = SpatialGenerator(latent_dim, hidden_dim, num_layers, compute_dtype)
        self.to_empty(device="cpu")
        _init_default(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, eps=None, generator=None) -> SpatialOutputs:
        B, P = x.shape[0], self.patch_size
        mu, logstd = self.encoder(x)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
        z = mu + eps * torch.exp(logstd)
        theta_mu = theta_logstd = dx_mu = dx_logstd = theta = dx = None
        k = 0
        if self.rotate:
            theta, theta_mu, theta_logstd = z[:, :1], mu[:, :1], logstd[:, :1]
            k = 1
        if self.translate:
            dx, dx_mu, dx_logstd = z[:, k:k + 2], mu[:, k:k + 2], logstd[:, k:k + 2]
            k += 2
        with span("coords"):
            coords = self.coordinates(theta, dx, B, x.device)
        with span("decode"):
            y = self.decoder(coords, z[:, k:])
        return SpatialOutputs(y.reshape(B, 1, P, P), mu[:, k:], logstd[:, k:], theta_mu,
                              theta_logstd, dx_mu, dx_logstd, self.theta_prior)

    def coordinates(self, theta, dx, B: int, device) -> torch.Tensor:
        """[B, n, 2] float32: the grid turned by theta [B, 1] and shifted by
        dx [B, 2] times dx_scale (each None to leave it out)."""
        grid = coordinate_grid(self.patch_size, device)
        if theta is None:
            coords = grid.expand(B, *grid.shape)
        else:  # the row vector (x, y) times [[cos, sin], [-sin, cos]]
            c, s = torch.cos(theta)[:, :, None], torch.sin(theta)[:, :, None]
            x, y = grid[None, :, 0:1], grid[None, :, 1:2]
            coords = torch.cat([x * c - y * s, x * s + y * c], dim=2)
        if dx is not None:
            coords = coords + self.dx_scale * dx[:, None, :]
        return coords


def _init_default(module: nn.Module, generator: torch.Generator | None) -> None:
    """PyTorch's default Linear init drawn from `generator`: kaiming_uniform(a=sqrt(5))
    weights, U(+-1/sqrt(fan_in)) biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.in_features)
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
