"""The plain VAE: the port's `VAE` with its fused train step and eval, the
plain reference in `reference/vae.py`, and its counts (the trunk it shares
with the rVAE and its transposed-convolution decoder). No hand-written
kernel runs on its path, and no cell analyses it: it binds no analysis."""

from __future__ import annotations

import torch

from portbench.counts.ops import conv_flops, dense_flops
from portbench.loops.common import augment_draws
from portbench.models.rvae import trunk_flops
from portbench.reference import vae as ref

PAIRED = False
draws = augment_draws


# --- program side ---

def train_model(cfg: dict, device) -> torch.nn.Module:
    from livae_tpu_torch.models.vae import VAE

    return VAE(cfg["latent_dim"], 1, cfg["patch_size"], cfg["precision"]["compute_dtype"],
               device=device, generator=torch.Generator().manual_seed(0))


def train_step(model, optimizer, scheduler, augment, cfg: dict, **kw):
    from livae_tpu_torch.train import engine

    use_diversity = cfg["loss"]["use_diversity"]
    step = engine.make_fused_vae_train_step(
        model, optimizer, cfg=augment, use_diversity=use_diversity,
        grad_max_norm=cfg["grad_max_norm"], scheduler=scheduler, **kw)
    return step, engine.make_fused_eval(model, use_diversity=use_diversity, **kw)


# --- reference side ---

reference_loss = ref.loss


# --- counts ---

def kernel_ops(phase: str, cfg: dict, padding: int, B: int, elem: int) -> list[tuple[str, int]]:
    return []


def forward_flops(S: int, latent: int) -> int:
    side, widths = S // 16, (256, 128, 64, 32, 1)
    f = trunk_flops(S, latent) + dense_flops(latent, 256 * side * side)
    for i in range(4):  # a transposed conv: 2 x C_in x C_out x k^2 per input pixel
        f += 2 * widths[i] * widths[i + 1] * 16 * (side << i) ** 2
    return f


def train_flops(S: int, latent: int) -> int:
    """Forward, weight gradients, and data gradients of every layer but the
    first trunk convolution, which sees data."""
    return 3 * forward_flops(S, latent) - conv_flops(1, 32, 4, S // 2, S // 2)
