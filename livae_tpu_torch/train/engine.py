"""Paired rVAE training, eval and encode (port of livae_tpu/train/engine.py).

The JAX package jits a whole epoch (extraction + steps) into one dispatch;
here the fused steps are plain Python loops over the [S, B] index batches.
Metrics accumulate on the device and reach the host once per epoch
(`metrics_to_host`), under the JAX package's metric names.

The train steps update the model's parameters and the optimizer state in
place, and clip the gradients in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pipeline import (
    PairedDraws,
    extract_batch,
    extract_batch_paired,
    extract_batch_paired_with_draws,
    sample_paired_draws,
)
from ..device import resolve_device
from ..losses import rvae_loss
from ..metrics import latent_stats, psnr, ssim

__all__ = [
    "FUSED_METRIC_NAMES",
    "metrics_to_host",
    "make_rvae_train_step",
    "make_fused_rvae_train_step",
    "make_fused_rvae_eval",
    "make_fused_encode",
]

FUSED_METRIC_NAMES = (
    "loss", "recon_loss", "kld_loss", "cycle_loss", "canonical_loss",
    "rotation_std", "grad_norm",
)


def _on_device(model: torch.nn.Module, device) -> torch.device:
    """The factories' device: CUDA unless asked otherwise; the model must be there."""
    dev = resolve_device(device)
    got = next(model.parameters()).device
    if got.type != dev.type:
        raise ValueError(f"model is on {got}, the step was asked to run on {dev}")
    return dev


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm / max(gnorm, 1e-12)); return
    min(gnorm, max_norm), the JAX package's formula (no 1e-6 added)."""
    gnorm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return torch.clamp(gnorm, max=max_norm)


def _common_metrics(recon, x, mu, logvar, theta) -> dict[str, torch.Tensor]:
    ls = latent_stats(mu, logvar)
    return {
        "psnr": psnr(recon, x),
        "ssim": ssim(recon, x),
        "latent_mean_abs": ls["latent_mean_abs"],
        "latent_std": ls["latent_std_mean"],
        "rotation_std": torch.std(theta),
    }


def _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                      canonical_weight, eps=None, generator=None):
    """The paired rVAE objective: rvae_loss with the cycle (or diversity)
    term on the theta of the rotated copy, plus canonical_weight * MSE
    between the decoder's canonical reconstruction and the STN-rotated input.
    Returns (total, aux)."""
    rotated_recon, canonical, theta, mu, logvar, canonical_input, theta_rot = (
        model.train_forward_paired(x, x_rot, eps, generator)
    )
    _, rl, kl, cyc = rvae_loss(
        rotated_recon, x, mu, logvar, theta, theta_rot, angle,
        beta=1.0, gamma=1.0, use_diversity=use_diversity,
    )
    total = rl + beta * kl + gamma * cyc
    canon_l = torch.mean((canonical - canonical_input) ** 2)
    if canonical_weight > 0:
        total = total + canonical_weight * canon_l
    aux = dict(recon=rotated_recon, canonical=canonical, canonical_input=canonical_input,
               theta=theta, mu=mu, logvar=logvar, rl=rl, kl=kl, cyc=cyc, canon_l=canon_l)
    return total, aux


def _update(model, optimizer, total, grad_max_norm) -> torch.Tensor:
    """Backward, global-norm clip and optimizer step; returns the reported norm."""
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    gnorm = _clip_by_global_norm(grads, grad_max_norm)
    optimizer.step()
    return gnorm


def make_rvae_train_step(model, optimizer, *, use_diversity: bool = False,
                         canonical_weight: float = 0.2, grad_max_norm: float = 20.0,
                         device=None):
    """Paired rVAE train step on a given batch.

    Returns step(x, x_rot, angle, beta, gamma, eps=None, generator=None) ->
    metrics dict of 0-d device tensors.
    """
    _on_device(model, device)

    def step(x, x_rot, angle, beta, gamma, eps=None, generator=None):
        total, aux = _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                                       canonical_weight, eps, generator)
        gnorm = _update(model, optimizer, total, grad_max_norm)
        with torch.no_grad():
            metrics = {
                "loss": total.detach(),
                "recon_loss": aux["rl"].detach(),
                "kld_loss": aux["kl"].detach(),
                "cycle_loss": aux["cyc"].detach(),
                "canonical_loss": aux["canon_l"].detach(),
                "grad_norm": gnorm,
                "canonical_psnr": psnr(aux["canonical"], aux["canonical_input"]),
                "canonical_ssim": ssim(aux["canonical"], aux["canonical_input"]),
            }
            metrics.update(_common_metrics(aux["recon"], x, aux["mu"], aux["logvar"],
                                           aux["theta"]))
        return metrics

    return step


def make_fused_rvae_train_step(model, optimizer, *, patch_size: int, padding: int, cfg,
                               margin: int, use_diversity: bool = False,
                               canonical_weight: float = 0.2, grad_max_norm: float = 20.0,
                               normalize: bool = True, device=None):
    """Whole-epoch rVAE training: paired extraction + one optimizer step per
    row of idx_batches.

    Returns step(frames_padded, img_idx, coords, idx_batches[S, B], generator,
    beta, gamma) -> {name: 0-d device tensor}, the means over the S steps.
    Augmentation draws and the reparameterisation noise come from
    `generator` (on the device).
    """
    dev = _on_device(model, device)
    rot_dtype = model.compute_dtype  # the rotated copy feeds only the STN's convs

    def step(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma):
        acc = torch.zeros(len(FUSED_METRIC_NAMES), device=dev)
        for idx in idx_batches:
            with torch.no_grad():
                x, x_rot, angle = extract_batch_paired(
                    frames_padded, img_idx[idx], coords[idx], generator, patch_size, padding,
                    cfg=cfg, margin=margin, normalize=normalize, rot_dtype=rot_dtype,
                )
            total, aux = _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                                           canonical_weight, generator=generator)
            gnorm = _update(model, optimizer, total, grad_max_norm)
            with torch.no_grad():
                acc += torch.stack([total, aux["rl"], aux["kl"], aux["cyc"], aux["canon_l"],
                                    torch.std(aux["theta"]), gnorm]).detach()
        return dict(zip(FUSED_METRIC_NAMES, acc / len(idx_batches)))

    return step


def _rvae_eval_metrics(model, x, x_rot, angle, beta, gamma, use_diversity, canonical_weight,
                       eps, generator):
    total, aux = _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                                   canonical_weight, eps, generator)
    metrics = {
        "loss": total,
        "recon_loss": aux["rl"],
        "kld_loss": aux["kl"],
        "cycle_loss": aux["cyc"],
        "canonical_loss": aux["canon_l"],
        "canonical_psnr": psnr(aux["canonical"], aux["canonical_input"]),
        "canonical_ssim": ssim(aux["canonical"], aux["canonical_input"]),
    }
    metrics.update(_common_metrics(aux["recon"], x, aux["mu"], aux["logvar"], aux["theta"]))
    return metrics


def make_fused_rvae_eval(model, *, patch_size: int, padding: int, cfg, margin: int,
                         use_diversity: bool = False, canonical_weight: float = 0.2,
                         normalize: bool = True, device=None):
    """Paired rVAE eval over [S, B] index batches, without gradients.

    Returns eval(frames_padded, img_idx, coords, idx_batches, generator, beta,
    gamma, draws=None, eps=None) -> {name: [S] device tensor}. `draws` (one
    PairedDraws per batch) and `eps` (one [B, latent] tensor per batch)
    replace the generator's draws, to reproduce another implementation's
    randomness.
    """
    dev = _on_device(model, device)
    rot_dtype = model.compute_dtype

    @torch.no_grad()
    def evaluate(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma,
                 draws: list[PairedDraws] | None = None, eps=None):
        per_batch = []
        for i, idx in enumerate(idx_batches):
            d = draws[i] if draws is not None else sample_paired_draws(
                idx.shape[0], cfg, generator, dev)
            x, x_rot, angle = extract_batch_paired_with_draws(
                frames_padded, img_idx[idx], coords[idx], d, patch_size, padding,
                margin=margin, normalize=normalize, rot_dtype=rot_dtype,
            )
            per_batch.append(_rvae_eval_metrics(
                model, x, x_rot, angle, beta, gamma, use_diversity, canonical_weight,
                None if eps is None else eps[i], generator,
            ))
        return {k: torch.stack([m[k] for m in per_batch]) for k in per_batch[0]}

    return evaluate


def make_fused_encode(model, *, patch_size: int, padding: int, margin: int,
                      normalize: bool = True, device=None):
    """Batched encode: un-augmented extraction + encoder over [S, B] indices.

    Returns encode(frames_padded, img_idx, coords, idx_batches) ->
    (mu [S*B, D], logvar [S*B, D], theta [S*B, 1]).
    """
    _on_device(model, device)

    @torch.no_grad()
    def encode(frames_padded, img_idx, coords, idx_batches):
        outs = []
        for idx in idx_batches:
            x = extract_batch(frames_padded, img_idx[idx], coords[idx], patch_size, padding,
                              normalize=normalize, margin=margin)
            outs.append(model.encode(x))
        mus, logvars, thetas = zip(*outs)
        return torch.cat(mus), torch.cat(logvars), torch.cat(thetas)

    return encode


def metrics_to_host(metrics: dict) -> dict[str, np.ndarray]:
    """Read a whole device-metrics dict back in one transfer; each entry comes
    back as a float32 numpy array of its own shape."""
    names = list(metrics)
    if not names:
        return {}
    vals = [torch.as_tensor(metrics[n]).float() for n in names]
    flat = torch.cat([v.reshape(-1) for v in vals]).cpu().numpy()
    out, off = {}, 0
    for n, v in zip(names, vals):
        out[n] = flat[off : off + v.numel()].reshape(tuple(v.shape))
        off += v.numel()
    return out
