"""Optimizers (port of `make_optimizer`, livae_tpu/train/state.py:74-98,
without the STN parameter group)."""

from __future__ import annotations

import torch

__all__ = ["make_optimizer"]


def make_optimizer(params, learning_rate: float, *, optimizer: str = "adam",
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax.adamw(lr, weight_decay=wd) / optax.adam(lr) as torch optimizers.

    Both use optax's defaults, betas (0.9, 0.999) and eps 1e-8; the weight decay
    is always the one asked for (torch's AdamW default of 0.01 never applies).
    """
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"Unknown optimizer: {optimizer}")
