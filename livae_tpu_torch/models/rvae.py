"""Rotationally-invariant VAE (port of livae_tpu/models/rvae.py, NCHW).

Module names follow the reference's state-dict keys
(livae_tpu/utils/checkpoint.py:75-97), so converted JAX weights load with a
plain `load_state_dict`:

* `encoder.rotation_stn.localization.{0,3,7,9}`: Conv5x5 -> MaxPool2 -> ReLU
  twice, then Linear -> ReLU -> Linear to an unnormalised [cos, sin];
* `encoder.conv_layers.{0,2,4,6}`: the stride-2 conv trunk, then `fc_mu` and
  `fc_logvar`;
* `decoder.fc`, `decoder.deconv_layers.{2,6,10,14}`: four
  Upsample2x -> ReflectionPad(1) -> Conv3x3 stages, then a sigmoid.

The JAX package computes the STN blocks and decoder stages with exact TPU
rewrites (ops/upconv.py); here they are the plain chains, convolutions on
cuDNN. The decoder's 2x bilinear upsample and reflection pad are written as
slices and two-tap sums (`_upsample2x`, `_reflect_pad1`): PyTorch's own
NCHW kernels for them took most of a batch-512 train step on the H100
(PERF.md).

Mixed precision follows the JAX policy (`compute_dtype`): convolutions cast
input, weight and bias to the compute dtype; the dense layers and the
losses stay float32; the STN rotation takes the compute dtype and the
inverse rotation returns float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.resample import rotate_image_fast
from .vae import ENCODER_WIDTHS, reparameterize

__all__ = ["RotationSTN", "Encoder", "Decoder", "RVAE", "init_torch_default"]


def _dtype(compute_dtype: str | None) -> torch.dtype | None:
    return None if compute_dtype is None else getattr(torch, compute_dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """conv(x) with input, weight and bias cast to the compute dtype."""
    w, b = conv.weight, conv.bias
    if cd is not None:
        x, w, b = x.to(cd), w.to(cd), b.to(cd)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False) of
    [B, C, H, W]: per axis out[2i] = 0.25 x[i-1] + 0.75 x[i] and
    out[2i+1] = 0.75 x[i] + 0.25 x[i+1], with the edges clamped."""
    for dim in (2, 3):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        x = torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)
    return x


def _reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """nn.ReflectionPad2d(1) of [B, C, H, W]."""
    x = torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], 2)
    return torch.cat([x[..., 1:2], x, x[..., -2:-1]], 3)


def init_torch_default(module: nn.Module, generator: torch.Generator | None) -> None:
    """PyTorch's default Conv/Linear init, drawn from `generator`:
    kaiming_uniform(a=sqrt(5)) weights, U(+-1/sqrt(fan_in)) biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)


class RotationSTN(nn.Module):
    """Localisation net predicting a canonicalising angle, plus its rotation."""

    def __init__(self, patch_size: int = 64, in_channels: int = 1,
                 compute_dtype: str | None = None):
        super().__init__()
        q = patch_size // 4
        self.compute_dtype = compute_dtype
        self.localization = nn.Sequential(
            nn.Conv2d(in_channels, 16, 5, padding=2),
            nn.MaxPool2d(2),
            nn.ReLU(),
            nn.Conv2d(16, 32, 5, padding=2),
            nn.MaxPool2d(2),
            nn.ReLU(),
            nn.Flatten(),
            nn.Linear(32 * q * q, 32),
            nn.ReLU(),
            nn.Linear(32, 2),
        )

    def init_head(self, generator: torch.Generator | None) -> None:
        """N(0, 0.01) weights and zero bias for the [cos, sin] head."""
        head = self.localization[9]
        with torch.no_grad():
            nn.init.normal_(head.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(head.bias)

    def localize(self, x: torch.Tensor):
        """x [B, C, H, W] -> (cos [B], sin [B], theta [B, 1])."""
        cd = _dtype(self.compute_dtype)
        loc = self.localization
        h = F.relu(F.max_pool2d(_conv(loc[0], x, cd), 2))
        h = F.relu(F.max_pool2d(_conv(loc[3], h, cd), 2))
        h = h.flatten(1).float()
        vec = loc[9](F.relu(loc[7](h)))
        norm = torch.linalg.vector_norm(vec, dim=1, keepdim=True)
        vec = vec / torch.clamp(norm, min=1e-6)
        cos_theta, sin_theta = vec[:, 0], vec[:, 1]
        theta = torch.atan2(sin_theta, cos_theta)[:, None]
        return cos_theta, sin_theta, theta

    def apply_rotation(self, x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """The canonicalising rotation, in the compute dtype."""
        cd = _dtype(self.compute_dtype)
        if cd is not None:
            x = x.to(cd)
        return rotate_image_fast(x, theta, padding_mode="reflection")

    def forward(self, x: torch.Tensor):
        _, _, theta = self.localize(x)
        return self.apply_rotation(x, theta), theta


class Encoder(nn.Module):
    """STN canonicalisation + conv trunk -> (mu, logvar, theta)."""

    def __init__(self, latent_dim: int = 10, patch_size: int = 64, in_channels: int = 1,
                 compute_dtype: str | None = None):
        super().__init__()
        s = patch_size // 16
        self.compute_dtype = compute_dtype
        self.rotation_stn = RotationSTN(patch_size, in_channels, compute_dtype)
        layers = []
        c_in = in_channels
        for w in ENCODER_WIDTHS:
            layers += [nn.Conv2d(c_in, w, 4, stride=2, padding=1), nn.ReLU()]
            c_in = w
        self.conv_layers = nn.Sequential(*layers)
        self.fc_mu = nn.Linear(256 * s * s, latent_dim)
        self.fc_logvar = nn.Linear(256 * s * s, latent_dim)

    def _trunk(self, x_rotated: torch.Tensor):
        cd = _dtype(self.compute_dtype)
        h = x_rotated
        for i in range(0, len(self.conv_layers), 2):
            h = F.relu(_conv(self.conv_layers[i], h, cd))
        h = h.flatten(1).float()
        return self.fc_mu(h), self.fc_logvar(h)

    def forward(self, x: torch.Tensor):
        mu, logvar, theta, _ = self.encode_with_canonical(x)
        return mu, logvar, theta

    def encode_with_canonical(self, x: torch.Tensor):
        """(mu, logvar, theta, x_canonical): x_canonical is the STN's rotation
        of x, the canonical-frame target of the training loss."""
        x_rotated, theta = self.rotation_stn(x)
        mu, logvar = self._trunk(x_rotated)
        return mu, logvar, theta, x_rotated

    def predict_theta(self, x: torch.Tensor) -> torch.Tensor:
        """Rotation angle only (localisation net; no rotation, no trunk)."""
        return self.rotation_stn.localize(x)[2]

    def encode_pair_with_canonical(self, x: torch.Tensor, x_rot: torch.Tensor):
        """encode_with_canonical(x) + predict_theta(x_rot), the two
        localisations as one [2B] pass. Returns
        (mu, logvar, theta, x_canonical, theta_rot)."""
        B = x.shape[0]
        both = torch.cat([x, x_rot.to(x.dtype)], dim=0)
        _, _, theta_b = self.rotation_stn.localize(both)
        theta, theta_rot = theta_b[:B], theta_b[B:]
        x_rotated = self.rotation_stn.apply_rotation(x, theta)
        mu, logvar = self._trunk(x_rotated)
        return mu, logvar, theta, x_rotated, theta_rot


class Decoder(nn.Module):
    """fc -> 4x [Upsample2x bilinear, ReflectionPad(1), Conv3x3] -> sigmoid."""

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
            layers += [
                nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                nn.ReflectionPad2d(1),
                nn.Conv2d(c_in, w, 3),
            ]
            if i < len(widths) - 1:
                layers.append(nn.ReLU())
            c_in = w
        layers.append(nn.Sigmoid())
        self.deconv_layers = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cd = _dtype(self.compute_dtype)
        h = F.relu(self.fc(z)).reshape(z.shape[0], 256, self.side, self.side)
        if cd is not None:
            h = h.to(cd)
        for i in (2, 6, 10, 14):
            h = _conv(self.deconv_layers[i], _reflect_pad1(_upsample2x(h)), cd)
            if i < 14:
                h = F.relu(h)
        return torch.sigmoid(h.float())


class RVAE(nn.Module):
    """rVAE; forward returns (rotated_recon, recon, theta, mu, logvar).

    The model factory of the port: built on `device` (CUDA unless
    `device="cpu"`), initialised from `generator` (a CPU torch.Generator;
    None draws from the global RNG).
    """

    def __init__(self, latent_dim: int = 10, in_channels: int = 1, patch_size: int = 64,
                 compute_dtype: str | None = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.latent_dim = latent_dim
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        # built without storage, then initialised once on the host from `generator`
        with torch.device("meta"):
            self.encoder = Encoder(latent_dim, patch_size, in_channels, compute_dtype)
            self.decoder = Decoder(latent_dim, in_channels, patch_size, compute_dtype)
        self.to_empty(device="cpu")
        init_torch_default(self, generator)
        self.encoder.rotation_stn.init_head(generator)
        self.to(device)

    def forward(self, x: torch.Tensor, eps=None, generator=None):
        return self.train_forward(x, eps, generator)[:5]

    def _decode_and_unrotate(self, mu, logvar, theta, eps, generator):
        """reparameterize -> decode -> inverse rotation (-theta), f32 out."""
        z = reparameterize(mu, logvar, eps, generator)
        recon = self.decoder(z)
        cd = _dtype(self.compute_dtype)
        rec_in = recon if cd is None else recon.to(cd)
        rotated_recon = rotate_image_fast(rec_in, -theta, padding_mode="reflection").float()
        return rotated_recon, recon

    def train_forward(self, x, eps=None, generator=None):
        """(rotated_recon, recon, theta, mu, logvar, x_canonical)."""
        mu, logvar, theta, x_canonical = self.encoder.encode_with_canonical(x)
        rotated_recon, recon = self._decode_and_unrotate(mu, logvar, theta, eps, generator)
        return rotated_recon, recon, theta, mu, logvar, x_canonical

    def train_forward_paired(self, x, x_rot, eps=None, generator=None):
        """train_forward(x) + predict_theta(x_rot), localisations batched."""
        mu, logvar, theta, x_canonical, theta_rot = self.encoder.encode_pair_with_canonical(
            x, x_rot
        )
        rotated_recon, recon = self._decode_and_unrotate(mu, logvar, theta, eps, generator)
        return rotated_recon, recon, theta, mu, logvar, x_canonical, theta_rot

    def encode(self, x: torch.Tensor):
        return self.encoder(x)
