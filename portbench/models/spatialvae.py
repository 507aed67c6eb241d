"""spatial-VAE's coordinate-decoder rVAE (Bepler et al., NeurIPS 2019): the
port's `SpatialVAE` with the generic fused train step and eval, the plain
reference in `reference/spatialvae.py`, and its counts (dense layers alone:
an inference MLP on the flattened patch, a coordinate MLP at every pixel).
No hand-written kernel runs on its path; its matrix products are cuBLAS's,
named under `KERNELS` as the operation "gemm". No cell analyses it: it binds
no analysis."""

from __future__ import annotations

import torch

from portbench.counts.ops import dense_flops
from portbench.loops.common import augment_draws
from portbench.reference import spatialvae as ref

PAIRED = False
# cuBLAS's and CUTLASS's matrix-product kernels on sm90, by name, case aside
KERNELS = {"gemm": [r"(?i)gemm", r"(?i)gemv", r"(?i)nvjet", r"(?i)splitKreduce",
                    r"(?i)cutlass.*sm90"]}

# the published widths (the upstream code's defaults), which the counts take
HIDDEN, LAYERS, Q_HIDDEN, Q_LAYERS = 500, 2, 500, 1


def noise_dim(cfg: dict) -> int:
    """The latents a patch draws noise for: z, theta, the 2-D shift."""
    return cfg["latent_dim"] + int(cfg["rotate"]) + 2 * int(cfg["translate"])


def draws(cfg: dict, B: int, generator: torch.Generator, device):
    """The augmentation draws, then [B, z + 3] noise."""
    return augment_draws({**cfg, "latent_dim": noise_dim(cfg)}, B, generator, device)


# --- program side ---

def train_model(cfg: dict, device) -> torch.nn.Module:
    from livae_tpu_torch.models.spatial_vae import SpatialVAE

    return SpatialVAE(cfg["latent_dim"], cfg["patch_size"], cfg["hidden_dim"], cfg["num_layers"],
                      cfg["q_hidden_dim"], cfg["q_num_layers"], cfg["rotate"], cfg["translate"],
                      cfg["loss"]["theta_prior"], cfg["loss"]["dx_scale"],
                      cfg["precision"]["compute_dtype"], device=device,
                      generator=torch.Generator().manual_seed(0))


def train_step(model, optimizer, scheduler, augment, cfg: dict, **kw):
    from livae_tpu_torch.train import engine

    step = engine.make_fused_vae_train_step(
        model, optimizer, cfg=augment, grad_max_norm=cfg["grad_max_norm"], scheduler=scheduler,
        **kw)
    return step, engine.make_fused_eval(model, **kw)


# --- reference side ---

reference_loss = ref.loss


# --- counts ---

def kernel_ops(phase: str, cfg: dict, padding: int, B: int, elem: int) -> list[tuple[str, int]]:
    return []


def forward_flops(S: int, latent: int) -> int:
    """Every pixel through the coordinate MLP (2 -> H, (L - 1) x H -> H,
    H -> 1), the latent's projection once a patch, and the inference MLP on
    the flattened patch to the mean and log-std of z, theta and the shift."""
    n, D = S * S, latent + 3
    per_pixel = (dense_flops(2, HIDDEN) + (LAYERS - 1) * dense_flops(HIDDEN, HIDDEN)
                 + dense_flops(HIDDEN, 1))
    q = (dense_flops(n, Q_HIDDEN) + (Q_LAYERS - 1) * dense_flops(Q_HIDDEN, Q_HIDDEN)
         + dense_flops(Q_HIDDEN, 2 * D))
    return n * per_pixel + dense_flops(latent, HIDDEN) + q


def train_flops(S: int, latent: int) -> int:
    """Forward, weight gradients, and data gradients of every layer but the
    inference net's first, which sees data (the coordinate layer's reach theta
    and the shift)."""
    return 3 * forward_flops(S, latent) - dense_flops(S * S, Q_HIDDEN)
