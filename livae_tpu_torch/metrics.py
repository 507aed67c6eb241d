"""Device metrics used by eval (port of psnr, ssim and latent_stats of
livae_tpu/metrics.py). Images are NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "latent_stats"]


def psnr(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB; inf when the images are identical."""
    mse = torch.mean((img1 - img2) ** 2)
    val = 20.0 * torch.log10(max_val / torch.sqrt(torch.clamp(mse, min=1e-30)))
    return torch.where(mse == 0, torch.full_like(val, float("inf")), val)


def _avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """avg_pool2d(window, stride 1, padding window//2), padding counted."""
    return F.avg_pool2d(x, window, stride=1, padding=window // 2, count_include_pad=True)


def ssim(img1, img2, window_size: int = 11, C1: float = 0.01**2, C2: float = 0.03**2):
    """Simplified average-pool SSIM."""
    mu1 = _avg_pool_same(img1, window_size)
    mu2 = _avg_pool_same(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _avg_pool_same(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _avg_pool_same(img2 * img2, window_size) - mu2_sq
    sigma12 = _avg_pool_same(img1 * img2, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


def latent_stats(mu: torch.Tensor, logvar: torch.Tensor) -> dict[str, torch.Tensor]:
    """Latent distribution statistics; std with Bessel's correction."""
    std = torch.exp(0.5 * logvar)
    return {
        "latent_mean_abs": mu.abs().mean(),
        "latent_mean_std": torch.std(mu),
        "latent_std_mean": std.mean(),
        "latent_std_std": torch.std(std),
        "latent_kl_per_dim": -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar)),
    }
