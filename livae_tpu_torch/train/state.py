"""Optimizers and schedules (port of livae_tpu/train/state.py).

* Adam with cosine warm restarts (T_0, T_mult) for the plain VAE.
* AdamW with a separate STN parameter group and learning rate, and cosine
  annealing, for the rVAE, plus `freeze_stn`.
* Linear beta annealing after a warm-up.

A schedule is a function of the optimizer-step count, read at the count
before the update and starting at 0 (optax's convention). `make_schedule`
gives the `LambdaLR` that writes each group's rate into the optimizer; the
train steps advance it once per optimizer step. Gradient clipping lives in the
train step, over the gradients of every parameter of the model.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.optim.lr_scheduler import LambdaLR

__all__ = [
    "cosine_annealing",
    "cosine_warm_restarts",
    "beta_at_epoch",
    "make_optimizer",
    "make_schedule",
]

Schedule = Callable[[int], float]


def _cosine_decay(lr: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha)."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def cosine_annealing(lr: float, total_steps: int, eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingLR(T_max=total_steps); constant at eta_min past it."""
    return _cosine_decay(lr, max(total_steps, 1), eta_min / lr if lr else 0.0)


def cosine_warm_restarts(lr: float, t0_steps: int, t_mult: int = 2,
                         total_steps: int | None = None, eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingWarmRestarts(T_0, T_mult) as joined cosines that cover
    `total_steps` (default 32 T_0). Past the last cosine's end the rate stays
    at eta_min: there is no further restart."""
    alpha = eta_min / lr if lr else 0.0
    horizon = total_steps if total_steps is not None else t0_steps * 32
    t, covered = max(t0_steps, 1), 0
    pieces: list[tuple[int, Schedule]] = []  # (first step, cosine)
    while covered < horizon:
        pieces.append((covered, _cosine_decay(lr, t, alpha)))
        covered += t
        t *= t_mult

    def schedule(count: int) -> float:
        start, piece = next(p for p in reversed(pieces) if p[0] <= count)
        return piece(count - start)

    return schedule


def beta_at_epoch(epoch: int, beta: float, anneal: bool = False, warmup_epochs: int = 5,
                  ramp_epochs: int = 15) -> float:
    """Beta annealing: 0 during the warm-up, a linear ramp, then beta."""
    if not anneal:
        return beta
    if epoch < warmup_epochs:
        return 0.0
    t = (epoch - warmup_epochs) / max(ramp_epochs, 1)
    return beta * min(1.0, t)


def _rate_at_0(rate) -> float:
    return float(rate(0)) if callable(rate) else float(rate)


def make_optimizer(params, learning_rate, *, optimizer: str = "adam",
                   weight_decay: float = 0.0, stn_learning_rate=None,
                   freeze_stn: bool = False) -> torch.optim.Optimizer:
    """optax.adamw(lr, weight_decay=wd) / optax.adam(lr) as torch optimizers.

    Both use optax's defaults, betas (0.9, 0.999) and eps 1e-8; the weight decay
    is always the one asked for (torch's AdamW default of 0.01 never applies).
    A rate may be a float or a schedule; a schedule sets the group's rate to
    its value at step 0, and `make_schedule` advances it.

    `stn_learning_rate` and `freeze_stn` need `params` to be the model (its
    parameter names tell the STN's apart): the STN's parameters then form a
    second group with their own rate, or, frozen, stay out of the optimizer:
    no update and no weight decay reaches them, while their gradients still
    count in the train step's global norm.
    """
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer: {optimizer}")
    if stn_learning_rate is None and not freeze_stn:
        plist = params.parameters() if isinstance(params, torch.nn.Module) else params
        groups = [{"params": list(plist), "lr": _rate_at_0(learning_rate)}]
    else:
        if not isinstance(params, torch.nn.Module):
            raise ValueError("the model is required for STN param-group optimizers")
        named = list(params.named_parameters())
        stn = [p for n, p in named if "rotation_stn" in n.split(".")]
        groups = [{"params": [p for n, p in named if "rotation_stn" not in n.split(".")],
                   "lr": _rate_at_0(learning_rate)}]
        if not freeze_stn:
            rate = stn_learning_rate if stn_learning_rate is not None else learning_rate
            groups.append({"params": stn, "lr": _rate_at_0(rate)})
    kw = dict(betas=(0.9, 0.999), eps=1e-8)
    if optimizer == "adamw":
        return torch.optim.AdamW(groups, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(groups, **kw)


def make_schedule(optimizer: torch.optim.Optimizer, learning_rate,
                  stn_learning_rate=None) -> LambdaLR:
    """The per-step schedule of an optimizer from `make_optimizer`, given the
    same rates: the first group follows `learning_rate`, a second (the STN's)
    `stn_learning_rate`, or `learning_rate` where that is None.

    A `LambdaLR` whose groups have the base rate 1.0, so a group's rate is
    rate(`last_epoch`) to the bit; `last_epoch` is the count of optimizer steps
    taken, and `step()` follows each `optimizer.step()`. Its state dict holds
    the count; the groups' rates come back with the optimizer's own state.
    """
    rates = [learning_rate]
    if len(optimizer.param_groups) > 1:
        rates.append(stn_learning_rate if stn_learning_rate is not None else learning_rate)
    for group in optimizer.param_groups:
        group["lr"] = group["initial_lr"] = 1.0
    return LambdaLR(optimizer, [r if callable(r) else (lambda count, r=float(r): r)
                                for r in rates])
