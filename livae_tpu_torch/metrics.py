"""Evaluation metrics (port of livae_tpu/metrics.py).

Device metrics used by eval (`psnr`, `ssim`, `latent_stats`) and the
host-facing API that returns floats and dicts: reconstruction metrics
(mse/rmse/mae/psnr/ssim), latent statistics, atom-detection fidelity and
`compute_all_metrics`. Images are NCHW (the JAX package's are NHWC); a 3-D
image is CHW. Numpy inputs become float32 tensors, as `jnp.asarray` makes
them in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial.distance import cdist

from .ops.peaks import peak_local_max

__all__ = [
    "compute_psnr",
    "compute_ssim",
    "compute_reconstruction_metrics",
    "compute_latent_metrics",
    "compute_atom_detection_metrics",
    "compute_all_metrics",
    "psnr",
    "ssim",
    "latent_stats",
]


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


# --- host-facing API (floats and dicts) ---

def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def compute_psnr(img1, img2, max_val: float = 1.0) -> float:
    return float(psnr(_tensor(img1), _tensor(img2), max_val))


def compute_ssim(img1, img2, window_size: int = 11, C1: float = 0.01**2,
                 C2: float = 0.03**2) -> float:
    """SSIM of NCHW batches, or of two CHW images."""
    img1, img2 = _tensor(img1), _tensor(img2)
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return float(ssim(img1, img2, window_size, C1, C2))


def compute_reconstruction_metrics(original, reconstruction) -> dict[str, float]:
    """mse / rmse / mae / psnr / ssim."""
    original, reconstruction = _tensor(original), _tensor(reconstruction)
    mse = float(torch.mean((original - reconstruction) ** 2))
    return {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": float(torch.mean(torch.abs(original - reconstruction))),
        "psnr": compute_psnr(original, reconstruction),
        "ssim": compute_ssim(original, reconstruction),
    }


def compute_latent_metrics(mu, logvar) -> dict[str, float]:
    return {k: float(v) for k, v in latent_stats(_tensor(mu), _tensor(logvar)).items()}


def _to_2d(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3:
        # accept HWC or CHW; squeeze singleton, else average channels
        if img.shape[-1] in (1, 3) and img.shape[0] not in (1, 3):
            img = img.mean(axis=-1) if img.shape[-1] != 1 else img[..., 0]
        elif img.shape[0] == 1:
            img = img[0]
        else:
            img = img.mean(axis=0)
    return img


def compute_atom_detection_metrics(
    original,
    reconstruction,
    lattice_spacing: float,
    threshold_ratio: float = 0.35,
) -> dict[str, float]:
    """Peak-position fidelity between original and reconstruction: detection
    rate, share of atoms within threshold_ratio * spacing, mean position error."""
    if lattice_spacing <= 0:
        raise ValueError("lattice_spacing must be positive")
    original_np = _to_2d(original)
    recon_np = _to_2d(reconstruction)

    min_distance = max(int(lattice_spacing * threshold_ratio), 1)
    orig_peaks = peak_local_max(original_np, min_distance=min_distance)
    recon_peaks = peak_local_max(recon_np, min_distance=min_distance)

    if orig_peaks.size == 0 or recon_peaks.size == 0:
        return {
            "atom_detection_rate": 0.0,
            "atom_position_accuracy": 0.0,
            "atom_mean_position_error": float("inf"),
            "n_original_atoms": int(orig_peaks.shape[0]) if orig_peaks.size else 0,
            "n_reconstructed_atoms": int(recon_peaks.shape[0]) if recon_peaks.size else 0,
        }

    distances = cdist(orig_peaks, recon_peaks)
    min_distances = distances.min(axis=1)
    threshold = lattice_spacing * threshold_ratio
    correct = int((min_distances < threshold).sum())
    return {
        "atom_detection_rate": float(recon_peaks.shape[0] / orig_peaks.shape[0]),
        "atom_position_accuracy": float(correct / orig_peaks.shape[0]),
        "atom_mean_position_error": float(min_distances.mean()),
        "n_original_atoms": int(orig_peaks.shape[0]),
        "n_reconstructed_atoms": int(recon_peaks.shape[0]),
    }


@torch.no_grad()
def compute_all_metrics(
    model,
    images,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    lattice_spacing: float | None = None,
) -> dict[str, float]:
    """Reconstruction + latent (+ atom detection) metrics of `model` on NCHW
    `images`, in one call. The reparameterisation noise is `eps` where given,
    else drawn from `generator`, else from a generator seeded 0 (the JAX
    package's default key(0)). A 3-output model is a VAE, a 5-output one an
    rVAE (its rotated reconstruction is scored)."""
    device = next(model.parameters()).device
    images = _tensor(images).to(device)
    if eps is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    outputs = model(images, eps, generator)
    if len(outputs) == 3:
        recon, mu, logvar = outputs
    elif len(outputs) == 5:
        recon, _, _, mu, logvar = outputs
    else:
        raise ValueError(f"Unexpected model output length: {len(outputs)}")

    metrics = {}
    metrics.update(compute_reconstruction_metrics(images, recon))
    metrics.update(compute_latent_metrics(mu, logvar))
    if lattice_spacing is not None:
        metrics.update(compute_atom_detection_metrics(images[0], recon[0], lattice_spacing))
    return metrics
