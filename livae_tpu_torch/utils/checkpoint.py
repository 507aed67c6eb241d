"""Reference-format checkpoints and the weight bridge (port of
livae_tpu/utils/checkpoint.py; the port imports nothing of the JAX package).

Checkpoints are `torch.save` files holding
{model_state, optimizer_state, epoch, best_val, args}; an STN-only form is
{"rotation_stn": state}; `clean_state_dict` strips torch.compile's
`_orig_mod.` prefixes on load. The port's modules carry the reference's
state-dict keys, so `model_state` is the model's own `state_dict()` and a
file the JAX package wrote loads with a strict `load_state_dict`.

The bridge converts Flax NHWC parameter trees (numpy leaves) to and from
that NCHW layout, including the flatten-order permutation of every Linear
that touches a flattened conv map.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = [
    "clean_state_dict",
    "vae_spec",
    "rvae_spec",
    "stn_spec",
    "model_spec",
    "params_to_torch_state",
    "torch_state_to_params",
    "load_jax_params",
    "save_checkpoint",
    "load_checkpoint",
    "save_reference_checkpoint",
    "load_reference_checkpoint",
]


def clean_state_dict(state_dict: dict) -> dict:
    """Strip `_orig_mod.` prefixes (torch.compile artifacts)."""
    return {k.replace("_orig_mod.", ""): v for k, v in state_dict.items()}


# Conversion specs: (flax_path, torch_key_prefix, kind, extra)
#
# kinds:
#   conv            Conv2d             torch [O, I, kh, kw]   <-> HWIO
#   convT           ConvTranspose2d    torch [I, O, kh, kw]   <-> HWIO
#   linear          Linear             torch [out, in]        <-> [in, out]
#   linear_flat_in  Linear after NCHW flatten; extra=(C, H, W) of the input map
#   linear_flat_out Linear whose output reshapes to (C, H, W); extra=(C, H, W)


def _trunk_spec(patch_size: int) -> list[tuple]:
    s = patch_size // 16
    spec = [
        (("encoder", f"conv{i}", "conv"), f"encoder.conv_layers.{conv_idx}", "conv", None)
        for i, conv_idx in enumerate((0, 2, 4, 6))
    ]
    spec.append((("encoder", "fc_mu", "dense"), "encoder.fc_mu", "linear_flat_in", (256, s, s)))
    spec.append(
        (("encoder", "fc_logvar", "dense"), "encoder.fc_logvar", "linear_flat_in", (256, s, s))
    )
    spec.append((("decoder", "fc", "dense"), "decoder.fc", "linear_flat_out", (256, s, s)))
    return spec


def vae_spec(patch_size: int, latent_dim: int) -> list[tuple]:
    """(flax_path, torch_key_prefix, kind, extra) for every VAE layer."""
    spec = _trunk_spec(patch_size)
    for i, conv_idx in enumerate((0, 2, 4, 6)):
        spec.append(
            (("decoder", f"deconv{i}"), f"decoder.deconv_layers.{conv_idx}", "convT", None)
        )
    return spec


def stn_spec(patch_size: int) -> list[tuple]:
    """RotationSTN-only spec, rooted at the STN subtree: the STN-pretraining
    checkpoint layout {"rotation_stn": {"localization.N.weight"/".bias"}}."""
    q = patch_size // 4
    return [
        (("loc_conv0", "conv"), "localization.0", "conv", None),
        (("loc_conv1", "conv"), "localization.3", "conv", None),
        (("loc_fc0", "dense"), "localization.7", "linear_flat_in", (32, q, q)),
        (("loc_fc1",), "localization.9", "linear", None),
    ]


def rvae_spec(patch_size: int, latent_dim: int) -> list[tuple]:
    """(flax_path, torch_key_prefix, kind, extra) for every RVAE layer."""
    spec = [
        (("encoder", "rotation_stn", *path), f"encoder.rotation_stn.{key}", kind, extra)
        for path, key, kind, extra in stn_spec(patch_size)
    ]
    spec += _trunk_spec(patch_size)
    for i, conv_idx in enumerate((2, 6, 10, 14)):
        spec.append(
            (("decoder", f"up_conv{i}", "conv"), f"decoder.deconv_layers.{conv_idx}", "conv", None)
        )
    return spec


def model_spec(model: torch.nn.Module) -> list[tuple]:
    """The spec of one of the port's models: rvae_spec for a model with an
    STN, else vae_spec."""
    make = rvae_spec if hasattr(model.encoder, "rotation_stn") else vae_spec
    return make(model.patch_size, model.latent_dim)


def _get(tree: dict, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def _set(tree: dict, path: tuple, leaf_name: str, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf_name] = value


def _flax_to_torch(kind: str, extra, kernel: np.ndarray, bias: np.ndarray):
    if kind == "conv":
        return kernel.transpose(3, 2, 0, 1), bias  # HWIO -> OIHW
    if kind == "convT":
        return kernel.transpose(2, 3, 0, 1), bias  # HWIO -> IOHW
    if kind == "linear":
        return kernel.T, bias
    if kind == "linear_flat_in":
        C, H, W = extra
        out = kernel.shape[1]
        # flax kernel [H*W*C, out] -> torch [out, C*H*W]
        w = kernel.reshape(H, W, C, out).transpose(3, 2, 0, 1).reshape(out, C * H * W)
        return w, bias
    if kind == "linear_flat_out":
        C, H, W = extra
        inp = kernel.shape[0]
        # flax kernel [in, H*W*C] -> torch [C*H*W, in]
        w = kernel.reshape(inp, H, W, C).transpose(3, 1, 2, 0).reshape(C * H * W, inp)
        b = bias.reshape(H, W, C).transpose(2, 0, 1).reshape(-1)
        return w, b
    raise ValueError(kind)


def _torch_to_flax(kind: str, extra, weight: np.ndarray, bias: np.ndarray):
    if kind == "conv":
        return weight.transpose(2, 3, 1, 0), bias  # OIHW -> HWIO
    if kind == "convT":
        return weight.transpose(2, 3, 0, 1), bias  # IOHW -> HWIO
    if kind == "linear":
        return weight.T, bias
    if kind == "linear_flat_in":
        C, H, W = extra
        out = weight.shape[0]
        k = weight.reshape(out, C, H, W).transpose(2, 3, 1, 0).reshape(H * W * C, out)
        return k, bias
    if kind == "linear_flat_out":
        C, H, W = extra
        inp = weight.shape[1]
        k = weight.reshape(C, H, W, inp).transpose(1, 2, 0, 3).reshape(H * W * C, inp)
        b = bias.reshape(C, H, W).transpose(1, 2, 0).reshape(-1)
        return k.T, b
    raise ValueError(kind)


def params_to_torch_state(params: dict, spec: list[tuple]) -> dict[str, np.ndarray]:
    """Flax param tree (numpy leaves) -> reference torch state dict (numpy)."""
    params = params.get("params", params)
    state: dict[str, np.ndarray] = {}
    for flax_path, torch_key, kind, extra in spec:
        node = _get(params, flax_path)
        kernel = np.asarray(node["kernel"], dtype=np.float32)
        bias = np.asarray(node["bias"], dtype=np.float32)
        w, b = _flax_to_torch(kind, extra, kernel, bias)
        state[f"{torch_key}.weight"] = w
        state[f"{torch_key}.bias"] = b
    return state


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def torch_state_to_params(state: dict, spec: list[tuple]) -> dict:
    """Reference torch state dict -> Flax-layout param tree {'params': ...}
    with numpy leaves."""
    state = clean_state_dict(state)
    tree: dict = {}
    for flax_path, torch_key, kind, extra in spec:
        weight = _to_numpy(state[f"{torch_key}.weight"])
        bias = _to_numpy(state[f"{torch_key}.bias"])
        k, b = _torch_to_flax(kind, extra, weight, bias)
        _set(tree, flax_path, "kernel", k)
        _set(tree, flax_path, "bias", b)
    return {"params": tree}


def load_jax_params(model: torch.nn.Module, params_np: dict) -> None:
    """Load a JAX RVAE or VAE param tree (numpy leaves) into the port's model,
    strictly."""
    state = params_to_torch_state(params_np, model_spec(model))
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}, strict=True
    )


def _to_cpu_tensors(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_cpu_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu_tensors(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj).copy())
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    return obj


def save_checkpoint(path: str | Path, payload: dict) -> None:
    """Write a torch.load-compatible checkpoint file: arrays and tensors
    become CPU tensors, everything else is pickled as it is. The file is
    written beside `path` and renamed over it, so a reader (a sweep's PBT
    exploit of a running trial) never sees a partial file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    torch.save(_to_cpu_tensors(payload), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str | Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def save_reference_checkpoint(
    path: str | Path,
    model_state: dict,
    *,
    optimizer_state: Any = None,
    epoch: int = 0,
    best_val: float = float("inf"),
    args: dict | None = None,
    extra: dict | None = None,
) -> None:
    """Write {model_state, optimizer_state, epoch, best_val, args};
    `model_state` is the model's `state_dict()`."""
    payload = {
        "model_state": clean_state_dict(model_state),
        "optimizer_state": optimizer_state,
        "epoch": epoch,
        "best_val": best_val,
        "args": args or {},
    }
    if extra:
        payload.update(extra)
    save_checkpoint(path, payload)


def load_reference_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """Read a reference-format checkpoint -> (state dict for a strict
    `load_state_dict`, full payload)."""
    payload = load_checkpoint(path)
    return clean_state_dict(payload["model_state"]), payload
