"""Plain VAE (port of livae_tpu/models/vae.py, NCHW) and the pieces the rVAE
shares with it.

Module names follow the reference's state-dict keys
(livae_tpu/utils/checkpoint.py:56-72): `encoder.conv_layers.{0,2,4,6}`
(stride-2 4x4 convolutions with ReLU), `encoder.fc_mu`, `encoder.fc_logvar`,
`decoder.fc`, `decoder.deconv_layers.{0,2,4,6}` (ConvTranspose2d k=4, s=2,
p=1, ReLU between them) and a sigmoid.

Mixed precision (`compute_dtype`): the convolutions cast input, weight and
bias to the compute dtype; the dense layers, mu, logvar and the sigmoid stay
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["ENCODER_WIDTHS", "reparameterize", "init_torch_default", "VAEEncoder",
           "VAEDecoder", "VAE"]

ENCODER_WIDTHS = (32, 64, 128, 256)


def reparameterize(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar).

    eps is drawn from `generator` (on mu's device) unless given; a caller that
    must reproduce another implementation's noise passes it in.
    """
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + eps * std


def _dtype(compute_dtype: str | None) -> torch.dtype | None:
    return None if compute_dtype is None else getattr(torch, compute_dtype)


def _conv(conv: nn.Module, x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """conv(x) with input, weight and bias cast to the compute dtype; `conv`
    is a Conv2d or a ConvTranspose2d."""
    w, b = conv.weight, conv.bias
    if cd is not None:
        x, w, b = x.to(cd), w.to(cd), b.to(cd)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


def init_torch_default(module: nn.Module, generator: torch.Generator | None) -> None:
    """PyTorch's default Conv/ConvTranspose/Linear init, drawn from `generator`:
    kaiming_uniform(a=sqrt(5)) weights, U(+-1/sqrt(fan_in)) biases, with fan_in
    taken from the weight's second axis on (so out * k * k for a ConvTranspose2d)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def _conv_trunk(in_channels: int) -> nn.Sequential:
    layers, c_in = [], in_channels
    for w in ENCODER_WIDTHS:
        layers += [nn.Conv2d(c_in, w, 4, stride=2, padding=1), nn.ReLU()]
        c_in = w
    return nn.Sequential(*layers)


class VAEEncoder(nn.Module):
    """Conv trunk -> (mu, logvar), both float32."""

    def __init__(self, latent_dim: int = 10, patch_size: int = 64, in_channels: int = 1,
                 compute_dtype: str | None = None):
        super().__init__()
        s = patch_size // 16
        self.compute_dtype = compute_dtype
        self.conv_layers = _conv_trunk(in_channels)
        self.fc_mu = nn.Linear(256 * s * s, latent_dim)
        self.fc_logvar = nn.Linear(256 * s * s, latent_dim)

    def forward(self, x: torch.Tensor):
        cd = _dtype(self.compute_dtype)
        h = x
        for i in range(0, len(self.conv_layers), 2):
            h = F.relu(_conv(self.conv_layers[i], h, cd))
        h = h.flatten(1).float()
        return self.fc_mu(h), self.fc_logvar(h)


class VAEDecoder(nn.Module):
    """fc -> 4x ConvTranspose2d(k=4, s=2, p=1) -> sigmoid."""

    def __init__(self, latent_dim: int = 10, out_channels: int = 1, patch_size: int = 64,
                 compute_dtype: str | None = None):
        super().__init__()
        self.side = patch_size // 16
        self.compute_dtype = compute_dtype
        self.fc = nn.Linear(latent_dim, 256 * self.side * self.side)
        layers: list[nn.Module] = []
        c_in = 256
        widths = (128, 64, 32, out_channels)
        for i, w in enumerate(widths):
            layers.append(nn.ConvTranspose2d(c_in, w, 4, stride=2, padding=1))
            layers.append(nn.ReLU() if i < len(widths) - 1 else nn.Sigmoid())
            c_in = w
        self.deconv_layers = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cd = _dtype(self.compute_dtype)
        h = F.relu(self.fc(z)).reshape(z.shape[0], 256, self.side, self.side)
        for i in (0, 2, 4, 6):
            h = _conv(self.deconv_layers[i], h, cd)
            if i < 6:
                h = F.relu(h)
        return torch.sigmoid(h.float())


class VAE(nn.Module):
    """Standard VAE; forward returns (recon, mu, logvar).

    Built on `device` (CUDA unless `device="cpu"`), initialised from
    `generator` (a CPU torch.Generator; None draws from the global RNG).
    """

    def __init__(self, latent_dim: int = 10, in_channels: int = 1, patch_size: int = 64,
                 compute_dtype: str | None = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.latent_dim = latent_dim
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        with torch.device("meta"):
            self.encoder = VAEEncoder(latent_dim, patch_size, in_channels, compute_dtype)
            self.decoder = VAEDecoder(latent_dim, in_channels, patch_size, compute_dtype)
        self.to_empty(device="cpu")
        init_torch_default(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, eps=None, generator=None):
        mu, logvar = self.encoder(x)
        z = reparameterize(mu, logvar, eps, generator)
        return self.decoder(z), mu, logvar

    def encode(self, x: torch.Tensor):
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
