"""Checkpoints in the reference's layout and weight conversion between the
JAX package and the port."""

from .checkpoint import (
    clean_state_dict,
    load_checkpoint,
    load_reference_checkpoint,
    params_to_torch_state,
    rvae_spec,
    save_checkpoint,
    save_reference_checkpoint,
    stn_spec,
    torch_state_to_params,
    vae_spec,
)

__all__ = [
    "clean_state_dict",
    "load_checkpoint",
    "load_reference_checkpoint",
    "params_to_torch_state",
    "rvae_spec",
    "save_checkpoint",
    "save_reference_checkpoint",
    "stn_spec",
    "torch_state_to_params",
    "vae_spec",
]
