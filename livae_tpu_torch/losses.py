"""VAE / rVAE losses (port of livae_tpu/losses.py).

Angle tensors may be [B] or [B, 1].
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "circular_distance",
    "rotation_diversity_loss",
    "cycle_consistency_loss",
    "vae_loss",
    "rvae_loss",
    "spatial_vae_loss",
]


def _as_col(theta: torch.Tensor) -> torch.Tensor:
    if theta.dim() == 0:
        theta = theta[None]
    if theta.dim() == 1:
        theta = theta[:, None]
    return theta


def circular_distance(theta1, theta2, eps: float = 1e-8) -> torch.Tensor:
    """Mean circular distance, min(d, 2pi - d)."""
    diff = torch.abs(_as_col(theta1) - _as_col(theta2))
    diff = torch.minimum(diff, 2 * math.pi - diff)
    return diff.mean()


def rotation_diversity_loss(theta, target_std: float = 1.0) -> torch.Tensor:
    """(std(theta) - target_std)^2 with Bessel's correction."""
    return (torch.std(theta) - target_std) ** 2


def cycle_consistency_loss(theta_original, theta_rotated, expected_angle) -> torch.Tensor:
    """mean(1 - cos((theta_rot - theta_orig) + angle))."""
    predicted_diff = _as_col(theta_rotated) - _as_col(theta_original)
    expected_diff = -_as_col(expected_angle)
    return torch.mean(1.0 - torch.cos(predicted_diff - expected_diff))


def vae_loss(recon_x, x, mu, logvar, beta: float = 1.0):
    """Mean-reduced VAE ELBO: (total, recon, kld)."""
    recon_loss = torch.mean((recon_x - x) ** 2)
    kld_loss = -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))
    return recon_loss + beta * kld_loss, recon_loss, kld_loss


def rvae_loss(
    recon_x, x, mu, logvar,
    theta=None, theta_rotated=None, expected_angle=None,
    beta: float = 1.0, gamma: float = 0.0, use_diversity: bool = False,
):
    """Sum-per-sample rVAE loss: (total, recon, kld, rotation)."""
    batch_size = x.shape[0]
    recon_loss = torch.sum((recon_x - x) ** 2) / batch_size
    kld_per_sample = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=1)
    kld_loss = kld_per_sample.mean()

    rotation_loss = torch.zeros((), dtype=recon_loss.dtype, device=recon_loss.device)
    if gamma > 0:
        if use_diversity and theta is not None:
            rotation_loss = rotation_diversity_loss(theta, target_std=1.0)
        elif theta is not None and theta_rotated is not None and expected_angle is not None:
            rotation_loss = cycle_consistency_loss(theta, theta_rotated, expected_angle)

    total = recon_loss + beta * kld_loss + gamma * rotation_loss
    return total, recon_loss, kld_loss, rotation_loss


def _normal_kl(mu, logstd, sigma: float = 1.0) -> torch.Tensor:
    """KL(N(mu, exp(logstd)^2) || N(0, sigma^2)), elementwise."""
    return (-logstd + math.log(sigma) + (torch.exp(2 * logstd) + mu**2) / (2 * sigma**2)
            - 0.5)


def spatial_vae_loss(recon_x, x, mu, logstd, theta_mu=None, theta_logstd=None, dx_mu=None,
                     dx_logstd=None, theta_prior: float = math.pi, beta: float = 1.0):
    """spatial-VAE's negative ELBO (Bepler et al. 2019): a unit-variance
    Gaussian reconstruction, 0.5 x the squared error summed over pixels, plus
    beta x the KL terms, each summed over its latents, all means over the
    batch: z against N(0, 1), theta against N(0, theta_prior^2), the
    unscaled shift dx against N(0, 1) (a group that is None is left out).
    Returns (total, recon, kld, {"kl_z", "kl_theta", "kl_dx"})."""
    batch_size = x.shape[0]
    recon_loss = 0.5 * torch.sum((recon_x - x) ** 2) / batch_size
    zero = torch.zeros((), dtype=recon_loss.dtype, device=recon_loss.device)
    terms = {"kl_z": _normal_kl(mu, logstd).sum(1).mean(), "kl_theta": zero, "kl_dx": zero}
    if theta_mu is not None:
        terms["kl_theta"] = _normal_kl(theta_mu, theta_logstd, theta_prior).sum(1).mean()
    if dx_mu is not None:
        terms["kl_dx"] = _normal_kl(dx_mu, dx_logstd).sum(1).mean()
    kld_loss = terms["kl_z"] + terms["kl_theta"] + terms["kl_dx"]
    return recon_loss + beta * kld_loss, recon_loss, kld_loss, terms
