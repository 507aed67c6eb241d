"""Weight bridge: JAX/Flax parameter trees -> the port's state dict.

A copy of the conversion half of livae_tpu/utils/checkpoint.py (numpy only;
the port imports nothing of the JAX package). Flax NHWC kernels become the
reference's NCHW torch layout, including the flatten-order permutation of
every Linear that touches a flattened conv map.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rvae_spec", "params_to_torch_state", "load_jax_params"]


def rvae_spec(patch_size: int, latent_dim: int) -> list[tuple]:
    """(flax_path, torch_key_prefix, kind, extra) for every RVAE layer."""
    s = patch_size // 16
    q = patch_size // 4
    spec = [
        (("encoder", "rotation_stn", "loc_conv0", "conv"), "encoder.rotation_stn.localization.0", "conv", None),
        (("encoder", "rotation_stn", "loc_conv1", "conv"), "encoder.rotation_stn.localization.3", "conv", None),
        (("encoder", "rotation_stn", "loc_fc0", "dense"), "encoder.rotation_stn.localization.7", "linear_flat_in", (32, q, q)),
        (("encoder", "rotation_stn", "loc_fc1"), "encoder.rotation_stn.localization.9", "linear", None),
    ]
    for i, conv_idx in enumerate((0, 2, 4, 6)):
        spec.append(
            (("encoder", f"conv{i}", "conv"), f"encoder.conv_layers.{conv_idx}", "conv", None)
        )
    spec.append((("encoder", "fc_mu", "dense"), "encoder.fc_mu", "linear_flat_in", (256, s, s)))
    spec.append(
        (("encoder", "fc_logvar", "dense"), "encoder.fc_logvar", "linear_flat_in", (256, s, s))
    )
    spec.append((("decoder", "fc", "dense"), "decoder.fc", "linear_flat_out", (256, s, s)))
    for i, conv_idx in enumerate((2, 6, 10, 14)):
        spec.append(
            (("decoder", f"up_conv{i}", "conv"), f"decoder.deconv_layers.{conv_idx}", "conv", None)
        )
    return spec


def _get(tree: dict, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def _flax_to_torch(kind: str, extra, kernel: np.ndarray, bias: np.ndarray):
    if kind == "conv":
        return kernel.transpose(3, 2, 0, 1), bias  # HWIO -> OIHW
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


def load_jax_params(model: torch.nn.Module, params_np: dict) -> None:
    """Load a JAX RVAE param tree (numpy leaves) into the port's RVAE, strictly."""
    state = params_to_torch_state(params_np, rvae_spec(model.patch_size, model.latent_dim))
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}, strict=True
    )
