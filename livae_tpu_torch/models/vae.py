"""Pieces shared with the plain VAE (port of livae_tpu/models/vae.py)."""

from __future__ import annotations

import torch

__all__ = ["ENCODER_WIDTHS", "reparameterize"]

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
