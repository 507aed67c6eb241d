"""Training, eval and encode steps (port of livae_tpu/train/engine.py).

The JAX package jits a whole epoch (extraction + steps) into one dispatch;
here the fused steps are plain Python loops over the [S, B] index batches.
Metrics accumulate on the device and reach the host once per epoch
(`metrics_to_host`), under the JAX package's metric names.

Two families: the paired rVAE steps (cycle consistency and the
canonical-frame loss), and the generic steps on unpaired batches, which
dispatch on the model's outputs: 3 (a plain VAE) or 5 (an rVAE trained with
the mean-reduced VAE loss on its rotated reconstruction).

The train steps update the model's parameters and the optimizer state in
place, clip the gradients in place over every parameter of the model, and
advance `scheduler` (from `make_schedule`) once per optimizer step.

The host-loop trainers (`train_one_epoch`, `evaluate`, `train_rvae_one_epoch`,
`evaluate_rvae`) drive the per-batch steps over given batches (a dataset's
`iter_epoch`), with batch i's noise drawn from a generator seeded from
(seed, i), and put the epoch's means into a MetricLogger.

Data and tensor parallelism: the fused steps and evals take `mesh=` (a
`parallel.DataMesh`, one rank per device). Each rank draws the global batch's
augmentation and noise and keeps its data index's rows, the train steps run
the loss through DistributedDataParallel over the data group, and the
metrics are those of the global batch (parallel/mesh.py). A model placed
with `parallel.place_with_specs` holds slices of its large dense layers; the
clip then takes the norm of the whole model: the split gradients' squares
summed over the model group, the replicated ones counted once.

Spans (`livae_tpu_torch.tracing`): each row of a fused train step is one
`train.step` (its `draws`, `extract`, `forward`, `loss`, `backward`, `clip`,
`optimizer` with the schedule, and `metrics`), each fused eval batch one
`eval.batch` (`draws`, `extract`, `forward`, `metrics`) inside
`evaluate_fused`'s `eval.pass`; `metrics_to_host` is `host_read`.
"""

from __future__ import annotations

import functools
import hashlib
import math
from collections import defaultdict
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import (
    PairedDraws,
    extract_batch,
    extract_batch_paired_with_draws,
    sample_paired_draws,
)
from ..device import resolve_device
from ..tracing import span
from ..losses import rotation_diversity_loss, rvae_loss, vae_loss
from ..metrics import compute_psnr, compute_ssim, latent_stats, psnr, ssim
from ..ops.resample import rotate_image_fast
from ..parallel.mesh import DataMesh, all_reduce_mean, gather_rows, shard_batch
from ..parallel.tensor import is_model_sharded

__all__ = [
    "FUSED_METRIC_NAMES",
    "FUSED_VAE_METRIC_NAMES",
    "MetricLogger",
    "metrics_to_host",
    "rotate_to_canonical",
    "make_train_step",
    "make_rvae_train_step",
    "make_fused_rvae_train_step",
    "make_fused_vae_train_step",
    "make_fused_encode",
    "make_fused_eval",
    "make_fused_rvae_eval",
    "make_eval_step",
    "make_rvae_eval_step",
    "evaluate_fused",
    "train_one_epoch",
    "evaluate",
    "train_rvae_one_epoch",
    "evaluate_rvae",
    "evaluate_rotation_invariance",
    "log_scalar_metrics_tensorboard",
    "log_reconstructions_tensorboard",
    "compute_psnr",
    "compute_ssim",
]

FUSED_METRIC_NAMES = (
    "loss", "recon_loss", "kld_loss", "cycle_loss", "canonical_loss",
    "rotation_std", "grad_norm",
)
FUSED_VAE_METRIC_NAMES = ("loss", "recon_loss", "kld_loss", "cycle_loss", "grad_norm")


class MetricLogger:
    """Dict-of-lists metric accumulator."""

    def __init__(self):
        self.metrics = defaultdict(list)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = v.item()
            self.metrics[k].append(v)

    def get_averages(self) -> dict[str, Any]:
        return {k: float(np.mean(v)) for k, v in self.metrics.items()}

    def reset(self):
        self.metrics.clear()


def rotate_to_canonical(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate images to the canonical frame by the predicted angles (+theta,
    reflection padding): the operation the STN applies."""
    return rotate_image_fast(x, theta, padding_mode="reflection")


def _on_device(model: torch.nn.Module, device) -> torch.device:
    """The factories' device: CUDA unless asked otherwise; the model must be there."""
    dev = resolve_device(device)
    got = next(model.parameters()).device
    if got.type != dev.type:
        raise ValueError(f"model is on {got}, the step was asked to run on {dev}")
    return dev


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                         sharded: list[bool] | None = None,
                         mesh: DataMesh | None = None) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm / max(gnorm, 1e-12)); return
    min(gnorm, max_norm), the JAX package's formula (no 1e-6 added). Under a
    model axis gnorm is the whole model's: the squares of the grads that
    `sharded` marks are summed over the model group."""
    if mesh is None or mesh.model_size == 1:
        gnorm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    else:
        def sum_sq(split: bool) -> torch.Tensor:
            return torch.stack([torch.sum(g * g) for g, s in zip(grads, sharded)
                                if s == split] or [grads[0].new_zeros(())]).sum()

        split = sum_sq(True)
        dist.all_reduce(split, group=mesh.model_group)
        gnorm = torch.sqrt(sum_sq(False) + split)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return torch.clamp(gnorm, max=max_norm)


def _common_metrics(recon, x, mu, logvar, theta) -> dict[str, torch.Tensor]:
    ls = latent_stats(mu, logvar)
    m = {
        "psnr": psnr(recon, x),
        "ssim": ssim(recon, x),
        "latent_mean_abs": ls["latent_mean_abs"],
        "latent_std": ls["latent_std_mean"],
    }
    if theta is not None:
        m["rotation_std"] = torch.std(theta)
    return m


def _paired_terms(outputs, x, angle, beta, gamma, use_diversity, canonical_weight,
                  mesh: DataMesh | None = None):
    """The paired rVAE objective of `train_forward_paired`'s outputs: rvae_loss
    with the cycle (or diversity) term on the theta of the rotated copy, plus
    canonical_weight * MSE between the decoder's canonical reconstruction and
    the STN-rotated input. Under a mesh the diversity term's std runs over the
    whole batch's theta. Returns (total, aux)."""
    rotated_recon, canonical, theta, mu, logvar, canonical_input, theta_rot = outputs
    theta_loss = gather_rows(theta, mesh, differentiable=True) if use_diversity else theta
    _, rl, kl, cyc = rvae_loss(
        rotated_recon, x, mu, logvar, theta_loss, theta_rot, angle,
        beta=1.0, gamma=1.0, use_diversity=use_diversity,
    )
    total = rl + beta * kl + gamma * cyc
    canon_l = torch.mean((canonical - canonical_input) ** 2)
    if canonical_weight > 0:
        total = total + canonical_weight * canon_l
    aux = dict(recon=rotated_recon, canonical=canonical, canonical_input=canonical_input,
               theta=theta, mu=mu, logvar=logvar, rl=rl, kl=kl, cyc=cyc, canon_l=canon_l)
    return total, aux


def _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                      canonical_weight, eps=None, generator=None, mesh=None):
    """`_paired_terms` of the model's paired forward. Returns (total, aux)."""
    with span("forward"):
        outputs = model.train_forward_paired(x, x_rot, eps, generator)
    with span("loss"):
        return _paired_terms(outputs, x, angle, beta, gamma, use_diversity, canonical_weight,
                             mesh)


class _Objective(torch.nn.Module):
    """A loss as the forward of a module that holds the model, so that
    DistributedDataParallel, which hooks a module's forward, can wrap it."""

    def __init__(self, model: torch.nn.Module, loss):
        super().__init__()
        self.model = model
        self.loss = loss

    def forward(self, *args):
        return self.loss(self.model, *args)


def _objective(model, loss, mesh: DataMesh | None):
    """loss(model, *args) as a callable. Under a mesh it runs through
    DistributedDataParallel over the data group, which broadcasts the
    group's first weights once and averages the gradients over the group in
    the backward; a 2-D mesh of one data way has nothing to average."""
    if mesh is None or (mesh.size == 1 and mesh.model_size > 1):
        return functools.partial(loss, model)
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(
        _Objective(model, loss), device_ids=[dev] if dev.type == "cuda" else None,
        process_group=mesh.data_group)


def _latent_dim(model) -> int:
    return model.decoder.fc.in_features


def _global_draws(B: int, cfg, generator, dev, draws, eps, latent_dim: int,
                  mesh: DataMesh | None, paired: bool):
    """One global batch's augmentation draws and noise, given or drawn from
    `generator` in the single-device order (draws, then noise), and this
    rank's rows of them. The paired extraction always draws (its angle at
    least), the unpaired one only with a cfg. Without a mesh the noise stays
    None unless given: the model draws it."""
    if draws is None and (paired or cfg is not None):
        draws = sample_paired_draws(B, cfg, generator, dev)
    if mesh is None:
        return draws, eps
    if eps is None:
        eps = torch.randn((B, latent_dim), generator=generator, dtype=torch.float32, device=dev)
    if draws is not None:
        draws = PairedDraws(**{k: shard_batch(v, mesh) for k, v in vars(draws).items()})
    return draws, shard_batch(eps, mesh)


def _global_std(sums: list[torch.Tensor], n: int, mesh: DataMesh) -> torch.Tensor:
    """The sum over steps of theta's std (Bessel) over each step's global batch
    of n, from each data index's per-step [sum, sum of squares] in float64."""
    s = torch.stack(sums)
    if mesh.size > 1:
        dist.all_reduce(s, group=mesh.data_group)
    var = (s[:, 1] - s[:, 0] ** 2 / n) / (n - 1)
    return torch.sqrt(torch.clamp(var, min=0.0)).sum().float()


def _theta_sums(theta: torch.Tensor) -> torch.Tensor:
    t = theta.detach().double()
    return torch.stack([t.sum(), (t * t).sum()])


def _update(model, optimizer, total, grad_max_norm, scheduler=None,
            mesh: DataMesh | None = None) -> torch.Tensor:
    """Backward, global-norm clip over every parameter of the model (also those
    the optimizer does not hold, a frozen STN's), optimizer step, then one step
    of the schedule; returns the reported norm."""
    with span("backward"):
        for p in model.parameters():
            p.grad = None
        total.backward()
    with span("clip"):
        held = [p for p in model.parameters() if p.grad is not None]
        gnorm = _clip_by_global_norm([p.grad for p in held], grad_max_norm,
                                     [is_model_sharded(p) for p in held], mesh)
    with span("optimizer"):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    return gnorm


def _generic_loss(model, x, beta, gamma, use_diversity, eps=None, generator=None, mesh=None):
    """`_generic_terms` of the model's forward. Returns (total, aux)."""
    with span("forward"):
        outputs = model(x, eps, generator)
    with span("loss"):
        return _generic_terms(outputs, x, beta, gamma, use_diversity, mesh)


def _generic_terms(outputs, x, beta, gamma, use_diversity, mesh: DataMesh | None = None):
    """The unpaired objective, dispatched on the model's outputs: the
    mean-reduced VAE loss on the (rotated) reconstruction, plus gamma times the
    rotation-diversity term (over the whole batch's theta under a mesh) for a
    5-output model when asked. Returns (total, aux); aux's theta and canonical
    are None for a plain VAE."""
    if len(outputs) == 3:
        recon, mu, logvar = outputs
        canonical = theta = None
    else:
        recon, canonical, theta, mu, logvar = outputs
    _, rl, kl = vae_loss(recon, x, mu, logvar, beta=1.0)
    total = rl + beta * kl
    cyc = torch.zeros((), device=x.device)
    if use_diversity and theta is not None:
        cyc = rotation_diversity_loss(gather_rows(theta, mesh, differentiable=True))
        total = total + gamma * cyc
    aux = dict(recon=recon, canonical=canonical, theta=theta, mu=mu, logvar=logvar,
               rl=rl, kl=kl, cyc=cyc)
    return total, aux


def make_train_step(model, optimizer, *, use_diversity: bool = False,
                    canonical_weight: float = 0.0, grad_max_norm: float = 5.0,
                    scheduler=None, device=None):
    """Generic train step on an unpaired batch (a VAE, or an rVAE under the
    mean-reduced VAE loss; with `canonical_weight` > 0 a 5-output model also
    gets canonical_weight x MSE(canonical, rotate_to_canonical(x, theta))).

    Returns step(x, beta, gamma, eps=None, generator=None) -> metrics dict of
    0-d device tensors.
    """
    _on_device(model, device)

    def step(x, beta, gamma, eps=None, generator=None):
        total, aux = _generic_loss(model, x, beta, gamma, use_diversity, eps, generator)
        canon_l = torch.zeros((), device=x.device)
        with_canonical = aux["canonical"] is not None and canonical_weight > 0
        if with_canonical:
            canon_l = torch.mean((aux["canonical"] - rotate_to_canonical(x, aux["theta"])) ** 2)
            total = total + canonical_weight * canon_l
        gnorm = _update(model, optimizer, total, grad_max_norm, scheduler)
        with torch.no_grad():
            metrics = {
                "loss": total.detach(),
                "recon_loss": aux["rl"].detach(),
                "kld_loss": aux["kl"].detach(),
                "cycle_loss": aux["cyc"].detach(),
                "canonical_loss": canon_l.detach(),
                "grad_norm": gnorm,
            }
            metrics.update(_common_metrics(aux["recon"], x, aux["mu"], aux["logvar"],
                                           aux["theta"]))
            if with_canonical:
                canonical_input = rotate_to_canonical(x, aux["theta"])
                metrics["canonical_psnr"] = psnr(aux["canonical"], canonical_input)
                metrics["canonical_ssim"] = ssim(aux["canonical"], canonical_input)
        return metrics

    return step


def make_rvae_train_step(model, optimizer, *, use_diversity: bool = False,
                         canonical_weight: float = 0.2, grad_max_norm: float = 20.0,
                         scheduler=None, device=None):
    """Paired rVAE train step on a given batch.

    Returns step(x, x_rot, angle, beta, gamma, eps=None, generator=None) ->
    metrics dict of 0-d device tensors.
    """
    _on_device(model, device)

    def step(x, x_rot, angle, beta, gamma, eps=None, generator=None):
        total, aux = _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                                       canonical_weight, eps, generator)
        gnorm = _update(model, optimizer, total, grad_max_norm, scheduler)
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
                               normalize: bool = True, scheduler=None, device=None,
                               mesh: DataMesh | None = None):
    """Whole-epoch rVAE training: paired extraction + one optimizer step per
    row of idx_batches.

    Returns step(frames_padded, img_idx, coords, idx_batches[S, B], generator,
    beta, gamma, draws=None, eps=None) -> {name: 0-d device tensor}, the means
    over the S steps. Augmentation draws and the reparameterisation noise come
    from `generator` (on the device); `draws` (one PairedDraws per step) and
    `eps` (one [B, latent] tensor per step) replace them, to reproduce another
    implementation's randomness. With `mesh`, idx_batches, draws and eps are
    the global batch's and this rank trains on its rows of them.
    """
    dev = _on_device(model, device)
    rot_dtype = model.compute_dtype  # the rotated copy feeds only the STN's convs

    def loss(model, x, x_rot, angle, beta, gamma, eps, generator):
        return _rvae_paired_loss(model, x, x_rot, angle, beta, gamma, use_diversity,
                                 canonical_weight, eps, generator, mesh)

    objective = _objective(model, loss, mesh)

    def step(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma,
             draws: list[PairedDraws] | None = None, eps=None):
        acc = torch.zeros(len(FUSED_METRIC_NAMES), device=dev)
        theta_sums = []
        for i, idx in enumerate(idx_batches):
            with span("train.step", new_tag=True):
                with torch.no_grad():
                    with span("draws"):
                        d, e = _global_draws(idx.shape[0], cfg, generator, dev,
                                             None if draws is None else draws[i],
                                             None if eps is None else eps[i], _latent_dim(model),
                                             mesh, paired=True)
                        idx = shard_batch(idx, mesh)
                    with span("extract"):
                        x, x_rot, angle = extract_batch_paired_with_draws(
                            frames_padded, img_idx[idx], coords[idx], d, patch_size, padding,
                            margin=margin, normalize=normalize, rot_dtype=rot_dtype,
                        )
                total, aux = objective(x, x_rot, angle, beta, gamma, e, generator)
                gnorm = _update(model, optimizer, total, grad_max_norm, scheduler, mesh)
                with torch.no_grad(), span("metrics"):
                    if mesh is None:
                        theta_std = torch.std(aux["theta"])
                    else:  # the global batch's std, from every rank's sums after the loop
                        theta_std = torch.zeros((), device=dev)
                        theta_sums.append(_theta_sums(aux["theta"]))
                    acc += torch.stack([total, aux["rl"], aux["kl"], aux["cyc"], aux["canon_l"],
                                        theta_std, gnorm]).detach()
        if mesh is not None:
            acc = all_reduce_mean(acc, mesh)
            acc[FUSED_METRIC_NAMES.index("rotation_std")] = _global_std(
                theta_sums, idx_batches.shape[1], mesh)
        return dict(zip(FUSED_METRIC_NAMES, acc / len(idx_batches)))

    return step


def make_fused_vae_train_step(model, optimizer, *, patch_size: int, padding: int, cfg,
                              margin: int, use_diversity: bool = False,
                              grad_max_norm: float = 5.0, normalize: bool = True,
                              scheduler=None, device=None, mesh: DataMesh | None = None):
    """Whole-epoch generic training on unpaired, augmented batches (the
    mean-reduced VAE loss; dispatch on the model's outputs as in
    `make_train_step`).

    Returns step(frames_padded, img_idx, coords, idx_batches[S, B], generator,
    beta, gamma, draws=None, eps=None) -> {name: 0-d device tensor}, the means
    over the S steps. `draws` (one PairedDraws per step) and `eps` (one
    [B, latent] tensor per step) replace the generator's draws, to reproduce
    another implementation's randomness. With `mesh`, as
    `make_fused_rvae_train_step`.
    """
    dev = _on_device(model, device)

    def loss(model, x, beta, gamma, eps, generator):
        return _generic_loss(model, x, beta, gamma, use_diversity, eps, generator, mesh)

    objective = _objective(model, loss, mesh)

    def step(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma,
             draws: list[PairedDraws] | None = None, eps=None):
        acc = torch.zeros(len(FUSED_VAE_METRIC_NAMES), device=dev)
        for i, idx in enumerate(idx_batches):
            with span("train.step", new_tag=True):
                with torch.no_grad():
                    with span("draws"):
                        d, e = _global_draws(idx.shape[0], cfg, generator, dev,
                                             None if draws is None else draws[i],
                                             None if eps is None else eps[i], _latent_dim(model),
                                             mesh, paired=False)
                        idx = shard_batch(idx, mesh)
                    with span("extract"):
                        x = extract_batch(frames_padded, img_idx[idx], coords[idx], patch_size,
                                          padding, normalize=normalize, margin=margin, cfg=cfg,
                                          draws=d)
                total, aux = objective(x, beta, gamma, e, generator)
                gnorm = _update(model, optimizer, total, grad_max_norm, scheduler, mesh)
                with torch.no_grad(), span("metrics"):
                    acc += torch.stack([total, aux["rl"], aux["kl"], aux["cyc"], gnorm]).detach()
        return dict(zip(FUSED_VAE_METRIC_NAMES, all_reduce_mean(acc, mesh) / len(idx_batches)))

    return step


def _generic_eval_metrics(model, x, beta, gamma, use_diversity, canonical_weight, eps,
                          generator, outputs=None):
    """The generic eval metrics of x; `outputs` (the model's on x) skip the
    forward."""
    if outputs is None:
        outputs = model(x, eps, generator)
    total, aux = _generic_terms(outputs, x, beta, gamma, use_diversity)
    metrics = {"loss": total, "recon_loss": aux["rl"], "kld_loss": aux["kl"],
               "cycle_loss": aux["cyc"]}
    metrics.update(_common_metrics(aux["recon"], x, aux["mu"], aux["logvar"], aux["theta"]))
    if aux["canonical"] is not None and canonical_weight > 0:
        canonical_input = rotate_to_canonical(x, aux["theta"])
        metrics["canonical_psnr"] = psnr(aux["canonical"], canonical_input)
        metrics["canonical_ssim"] = ssim(aux["canonical"], canonical_input)
    return metrics


def _rvae_eval_metrics(model, x, x_rot, angle, beta, gamma, use_diversity, canonical_weight,
                       eps, generator, outputs=None):
    """The paired eval metrics of (x, x_rot, angle); `outputs` (the model's
    paired forward on them) skip the forward."""
    if outputs is None:
        outputs = model.train_forward_paired(x, x_rot, eps, generator)
    total, aux = _paired_terms(outputs, x, angle, beta, gamma, use_diversity, canonical_weight)
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


def _gathered(outputs, mesh: DataMesh | None):
    return None if mesh is None else tuple(gather_rows(o, mesh) for o in outputs)


def make_fused_rvae_eval(model, *, patch_size: int, padding: int, cfg, margin: int,
                         use_diversity: bool = False, canonical_weight: float = 0.2,
                         normalize: bool = True, device=None, mesh: DataMesh | None = None):
    """Paired rVAE eval over [S, B] index batches, without gradients.

    Returns eval(frames_padded, img_idx, coords, idx_batches, generator, beta,
    gamma, draws=None, eps=None) -> {name: [S] device tensor}. `draws` (one
    PairedDraws per batch) and `eps` (one [B, latent] tensor per batch)
    replace the generator's draws, to reproduce another implementation's
    randomness. With `mesh` each rank runs the model on its rows of every
    batch, and the metrics are those of the gathered batch, on every rank.
    """
    dev = _on_device(model, device)
    rot_dtype = model.compute_dtype

    @torch.no_grad()
    def evaluate(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma,
                 draws: list[PairedDraws] | None = None, eps=None):
        per_batch = []
        for i, idx in enumerate(idx_batches):
            with span("eval.batch", new_tag=True):
                with span("draws"):
                    d, e = _global_draws(idx.shape[0], cfg, generator, dev,
                                         None if draws is None else draws[i],
                                         None if eps is None else eps[i], _latent_dim(model),
                                         mesh, paired=True)
                    idx = shard_batch(idx, mesh)
                with span("extract"):
                    x, x_rot, angle = extract_batch_paired_with_draws(
                        frames_padded, img_idx[idx], coords[idx], d, patch_size, padding,
                        margin=margin, normalize=normalize, rot_dtype=rot_dtype,
                    )
                with span("forward"):
                    if mesh is None:
                        outputs = model.train_forward_paired(x, x_rot, e, generator)
                    else:
                        outputs = _gathered(model.train_forward_paired(x, x_rot, e), mesh)
                        x, angle = gather_rows(x, mesh), gather_rows(angle, mesh)
                with span("metrics"):
                    per_batch.append(_rvae_eval_metrics(
                        model, x, x_rot, angle, beta, gamma, use_diversity, canonical_weight, e,
                        generator, outputs,
                    ))
        return {k: torch.stack([m[k] for m in per_batch]) for k in per_batch[0]}

    return evaluate


def make_eval_step(model, *, use_diversity: bool = False, canonical_weight: float = 0.0,
                   device=None):
    """Generic eval step: step(x, beta, gamma, eps=None, generator=None) ->
    metrics dict, without gradients."""
    _on_device(model, device)

    @torch.no_grad()
    def step(x, beta, gamma, eps=None, generator=None):
        return _generic_eval_metrics(model, x, beta, gamma, use_diversity, canonical_weight,
                                     eps, generator)

    return step


def make_rvae_eval_step(model, *, use_diversity: bool = False, canonical_weight: float = 0.2,
                        device=None):
    """Paired rVAE eval step: step(x, x_rot, angle, beta, gamma, eps=None,
    generator=None) -> metrics dict, without gradients."""
    _on_device(model, device)

    @torch.no_grad()
    def step(x, x_rot, angle, beta, gamma, eps=None, generator=None):
        return _rvae_eval_metrics(model, x, x_rot, angle, beta, gamma, use_diversity,
                                  canonical_weight, eps, generator)

    return step


def make_fused_eval(model, *, patch_size: int, padding: int, margin: int,
                    use_diversity: bool = False, canonical_weight: float = 0.0,
                    normalize: bool = True, device=None, mesh: DataMesh | None = None):
    """Generic eval over [S, B] index batches: un-augmented extraction and the
    eval metrics, without gradients.

    Returns eval(frames_padded, img_idx, coords, idx_batches, generator, beta,
    gamma, eps=None) -> {name: [S] device tensor}; `eps` (one [B, latent]
    tensor per batch) replaces the generator's noise. With `mesh`, as
    `make_fused_rvae_eval`.
    """
    dev = _on_device(model, device)

    @torch.no_grad()
    def evaluate(frames_padded, img_idx, coords, idx_batches, generator, beta, gamma, eps=None):
        per_batch = []
        for i, idx in enumerate(idx_batches):
            with span("eval.batch", new_tag=True):
                with span("draws"):
                    _, e = _global_draws(idx.shape[0], None, generator, dev, None,
                                         None if eps is None else eps[i], _latent_dim(model),
                                         mesh, paired=False)
                    idx = shard_batch(idx, mesh)
                with span("extract"):
                    x = extract_batch(frames_padded, img_idx[idx], coords[idx], patch_size,
                                      padding, normalize=normalize, margin=margin)
                with span("forward"):
                    if mesh is None:
                        outputs = model(x, e, generator)
                    else:
                        outputs = _gathered(model(x, e), mesh)
                        x = gather_rows(x, mesh)
                with span("metrics"):
                    per_batch.append(_generic_eval_metrics(
                        model, x, beta, gamma, use_diversity, canonical_weight, e, generator,
                        outputs,
                    ))
        return {k: torch.stack([m[k] for m in per_batch]) for k in per_batch[0]}

    return evaluate


def evaluate_fused(fused_eval, site_table, val_idx, batch_size: int, generator,
                   metric_logger: MetricLogger | None = None, beta: float = 1.0,
                   gamma: float = 0.0, prefix: str = "val_", tail_eval=None) -> dict[str, float]:
    """Run a fused eval over all val sites: the full batches, then the ragged
    tail (val size not divisible by batch_size) as one smaller batch, through
    `tail_eval` where given (the eval without a mesh, as the JAX package's
    `tail_eval`). Batches weigh equally, the tail too."""
    frames_padded, img_idx, coords, _ = site_table
    with span("eval.pass", new_tag=True):
        with span("indices"):
            val_idx = torch.as_tensor(np.asarray(val_idx), dtype=torch.long,
                                      device=frames_padded.device)
        n = len(val_idx)
        bs = min(batch_size, n)
        n_full = n // bs
        per_batch = []
        if n_full > 0:
            main = val_idx[: n_full * bs].reshape(n_full, bs)
            per_batch.append(fused_eval(frames_padded, img_idx, coords, main, generator, beta,
                                        gamma))
        if n_full * bs < n:
            tail = val_idx[n_full * bs :].reshape(1, -1)
            per_batch.append((tail_eval or fused_eval)(frames_padded, img_idx, coords, tail,
                                                       generator, beta, gamma))
        sums: dict[str, float] = defaultdict(float)
        count = 0
        for d in per_batch:
            d = metrics_to_host(d)  # one transfer per fused-eval dict
            count += len(next(iter(d.values())))
            for k, v in d.items():
                sums[k] += float(np.sum(v))
    avg = {prefix + k: v / count for k, v in sums.items()}
    if metric_logger is not None:
        metric_logger.update(**avg)
    return avg


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
            out = model.encode(x)
            if len(out) == 2:  # a plain VAE has no angle
                out = (*out, torch.zeros((out[0].shape[0], 1), dtype=out[0].dtype,
                                         device=out[0].device))
            outs.append(out)
        mus, logvars, thetas = zip(*outs)
        return torch.cat(mus), torch.cat(logvars), torch.cat(thetas)

    return encode


@torch.no_grad()
def evaluate_rotation_invariance(
    model,
    images: torch.Tensor,
    angles: Iterable[float] = (0, 45, 90, 135, 180, 225, 270, 315),
    eps: Sequence[torch.Tensor] | None = None,
) -> dict[str, float]:
    """Rotate the probes `images` [B, 1, S, S] through fixed angles (degrees)
    and measure how invariant the latents and reconstructions are.

    Per angle: rotate the probes (reflection padding), run the rVAE, rotate its
    rotated reconstruction back, and score it against the probes. Returns
    latent_variance (the mean over latents and probes of mu's variance across
    angles), recon_rmse / recon_psnr / recon_ssim (means over angles), and
    angle_error: the mean absolute circular error of theta_a against
    theta_0 - a (radians). The noise of angle i is `eps[i]` where given, else
    drawn from one generator seeded 0 (the JAX package takes fold_in(key, i)).
    """
    device = next(model.parameters()).device
    images = images.to(device)
    generator = torch.Generator(device=device).manual_seed(0) if eps is None else None
    # the angles as float32, as the JAX package computes them
    angles_rad = torch.tensor([a * math.pi / 180.0 for a in angles], dtype=torch.float32,
                              device=device)
    B = images.shape[0]
    mus, rmses, psnrs, ssims, angle_errs = [], [], [], [], []
    base_theta = None
    for i, a in enumerate(angles_rad):
        angle_vec = a.expand(B)
        rotated = rotate_image_fast(images, angle_vec, "reflection")
        rotated_recon, _recon, theta, mu, _logvar = model(
            rotated, None if eps is None else eps[i], generator)
        unrotated = rotate_image_fast(rotated_recon, -angle_vec, "reflection")
        mus.append(mu)
        rmses.append(torch.sqrt(torch.mean((unrotated - images) ** 2)))
        psnrs.append(psnr(unrotated, images))
        ssims.append(ssim(unrotated, images))
        if base_theta is None:
            base_theta = theta
        else:
            # theta should decrease by the applied angle: theta_a ~ theta_0 - a
            diff = (theta - base_theta)[:, 0] + a
            angle_errs.append(torch.mean(torch.abs(torch.atan2(torch.sin(diff), torch.cos(diff)))))

    stats = {
        "latent_variance": torch.mean(torch.var(torch.stack(mus), dim=0, unbiased=False)),
        "recon_rmse": torch.stack(rmses).mean(),
        "recon_psnr": torch.stack(psnrs).mean(),
        "recon_ssim": torch.stack(ssims).mean(),
    }
    if angle_errs:
        stats["angle_error"] = torch.stack(angle_errs).mean()
    host = {k: float(v) for k, v in metrics_to_host(stats).items()}  # one transfer
    host.setdefault("angle_error", 0.0)
    return host


def metrics_to_host(metrics: dict) -> dict[str, np.ndarray]:
    """Read a whole device-metrics dict back in one transfer; each entry comes
    back as a float32 numpy array of its own shape."""
    names = list(metrics)
    if not names:
        return {}
    with span("host_read"):
        vals = [torch.as_tensor(metrics[n]).float() for n in names]
        flat = torch.cat([v.reshape(-1) for v in vals]).cpu().numpy()
    out, off = {}, 0
    for n, v in zip(names, vals):
        out[n] = flat[off : off + v.numel()].reshape(tuple(v.shape))
        off += v.numel()
    return out


def _accumulate_epoch(metric_dicts: list[dict]) -> dict[str, float]:
    """Sum per-batch metric dicts on the device (in batch order); one host
    read; the means over the batches."""
    if not metric_dicts:
        return {}
    acc = dict(metric_dicts[0])
    for m in metric_dicts[1:]:
        acc = {k: acc[k] + m[k] for k in acc}
    n = len(metric_dicts)
    return {k: float(v) / n for k, v in metrics_to_host(acc).items()}


def _batch_generator(seed: int, i: int, device) -> torch.Generator:
    """Batch i's generator on `device`, seeded from (seed, i): where the JAX
    package takes fold_in(key, i)."""
    digest = hashlib.sha256(f"{seed}/batch/{i}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def _log_epoch(collected: list[dict], metric_logger: MetricLogger, prefix: str) -> dict[str, float]:
    avg = {prefix + k: v for k, v in _accumulate_epoch(collected).items()}
    metric_logger.update(**avg)
    return avg


def train_one_epoch(step_fn, batches: Iterable, seed: int, metric_logger: MetricLogger,
                    beta: float = 1.0, gamma: float = 0.0,
                    prefix: str = "train_") -> dict[str, float]:
    """Epoch loop over unpaired batches (a tuple's first element is the batch)
    with a step from `make_train_step`; returns the epoch's prefixed means."""
    collected = []
    for i, x in enumerate(batches):
        if isinstance(x, (list, tuple)):
            x = x[0]
        collected.append(step_fn(x, beta, gamma, generator=_batch_generator(seed, i, x.device)))
    return _log_epoch(collected, metric_logger, prefix)


def evaluate(eval_step_fn, batches: Iterable, seed: int, metric_logger: MetricLogger,
             beta: float = 1.0, gamma: float = 0.0, prefix: str = "val_") -> dict[str, float]:
    """Eval loop over unpaired batches with a step from `make_eval_step`; every
    batch weighs the same. Returns the prefixed means."""
    collected = []
    for i, x in enumerate(batches):
        if isinstance(x, (list, tuple)):
            x = x[0]
        collected.append(eval_step_fn(x, beta, gamma,
                                      generator=_batch_generator(seed, i, x.device)))
    return _log_epoch(collected, metric_logger, prefix)


def train_rvae_one_epoch(step_fn, paired_batches: Iterable, seed: int,
                         metric_logger: MetricLogger, beta: float = 1.0, gamma: float = 0.0,
                         prefix: str = "train_") -> dict[str, float]:
    """Epoch loop over (x, x_rot, angle) batches with a step from
    `make_rvae_train_step`; returns the epoch's prefixed means."""
    collected = []
    for i, (x, x_rot, angle) in enumerate(paired_batches):
        collected.append(step_fn(x, x_rot, angle, beta, gamma,
                                 generator=_batch_generator(seed, i, x.device)))
    return _log_epoch(collected, metric_logger, prefix)


def evaluate_rvae(eval_step_fn, paired_batches: Iterable, seed: int,
                  metric_logger: MetricLogger, beta: float = 1.0, gamma: float = 0.0,
                  prefix: str = "val_") -> dict[str, float]:
    """Paired eval loop with a step from `make_rvae_eval_step`; every batch
    weighs the same. Returns the prefixed means."""
    collected = []
    for i, (x, x_rot, angle) in enumerate(paired_batches):
        collected.append(eval_step_fn(x, x_rot, angle, beta, gamma,
                                      generator=_batch_generator(seed, i, x.device)))
    return _log_epoch(collected, metric_logger, prefix)


# TensorBoard logging (the JAX package's tag schema)

def _make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """torchvision.utils.make_grid for [N, 1, H, W] arrays -> [H', W']."""
    n, h, w = images.shape[0], images.shape[2], images.shape[3]
    ncol = min(nrow, n)
    nr = -(-n // ncol)
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad), dtype=np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + c * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[i, 0]
    return grid


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def log_reconstructions_tensorboard(writer, x, recon, epoch: int, tag: str = "reconstructions",
                                    max_images: int = 8, canonical=None,
                                    canonical_input=None) -> None:
    """[original | reconstruction | abs diff] grids (and the canonical triplet)."""
    x, recon = _host(x[:max_images]), _host(recon[:max_images])
    grid = np.concatenate([_make_grid(x, max_images), _make_grid(recon, max_images),
                           _make_grid(np.abs(x - recon), max_images)], axis=0)
    writer.add_image(tag, grid[None, :, :], epoch)
    if canonical is not None and canonical_input is not None:
        c, ci = _host(canonical[:max_images]), _host(canonical_input[:max_images])
        cgrid = np.concatenate([_make_grid(ci, max_images), _make_grid(c, max_images),
                                _make_grid(np.abs(ci - c), max_images)], axis=0)
        writer.add_image(f"{tag}_canonical", cgrid[None, :, :], epoch)


def log_scalar_metrics_tensorboard(writer, metrics: dict[str, float], epoch: int) -> None:
    """train_x -> train/x, val_x -> val/x tags."""
    for key, value in metrics.items():
        if key.startswith("train_"):
            writer.add_scalar(f"train/{key[6:]}", value, epoch)
        elif key.startswith("val_"):
            writer.add_scalar(f"val/{key[4:]}", value, epoch)
        else:
            writer.add_scalar(key, value, epoch)
