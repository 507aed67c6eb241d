"""Optimizers and the train / eval / encode steps."""

from .engine import (
    MetricLogger,
    evaluate,
    evaluate_rotation_invariance,
    evaluate_rvae,
    log_reconstructions_tensorboard,
    log_scalar_metrics_tensorboard,
    make_eval_step,
    make_fused_encode,
    make_fused_rvae_train_step,
    make_fused_vae_train_step,
    make_rvae_eval_step,
    make_rvae_train_step,
    make_train_step,
    rotate_to_canonical,
    train_one_epoch,
    train_rvae_one_epoch,
)
from .state import beta_at_epoch, cosine_annealing, cosine_warm_restarts, make_optimizer

__all__ = [
    "MetricLogger",
    "beta_at_epoch",
    "cosine_annealing",
    "cosine_warm_restarts",
    "evaluate",
    "evaluate_rotation_invariance",
    "evaluate_rvae",
    "log_reconstructions_tensorboard",
    "log_scalar_metrics_tensorboard",
    "make_eval_step",
    "make_fused_encode",
    "make_fused_rvae_train_step",
    "make_fused_vae_train_step",
    "make_optimizer",
    "make_rvae_eval_step",
    "make_rvae_train_step",
    "make_train_step",
    "rotate_to_canonical",
    "train_one_epoch",
    "train_rvae_one_epoch",
]
