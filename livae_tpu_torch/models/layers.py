"""Layers of the port's rVAE (port of livae_tpu/models/layers.py, NCHW).

The JAX module wraps flax's layers to match PyTorch (`Conv`, `ConvTranspose`,
`Dense`, and the initialisers `torch_kernel_init`, `torch_bias_init`); here
they are PyTorch's own `nn.Conv2d`, `nn.ConvTranspose2d`, `nn.Linear` and
default init (`models.vae.init_torch_default`). What the port needs of it are
the two fused layers, which compute at half resolution (ops/upconv.py), and
the unfused chains' pool and pad.

`FusedUpConv` and `FusedConvPool` are `nn.Conv2d`s (3x3 and 5x5, the
reference's state-dict keys and init), whose forward is the fused form. Both
cast input, weight and bias to `compute_dtype` first (the JAX layers' `dtype`),
so the phase kernels are built from the rounded weights as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.upconv import fused_conv5_relu_maxpool, fused_upsample_reflect_conv

__all__ = ["FusedConvPool", "FusedUpConv", "max_pool_2x2", "reflection_pad_1"]


def _cast(layer: nn.Conv2d, x: torch.Tensor):
    """(x, weight, bias) in the layer's compute dtype."""
    w, b = layer.weight, layer.bias
    if layer.compute_dtype is not None:
        cd = getattr(torch, layer.compute_dtype)
        x, w, b = x.to(cd), w.to(cd), b.to(cd)
    return x, w, b


class FusedUpConv(nn.Conv2d):
    """Decoder stage [Upsample2x bilinear -> ReflectionPad(1) -> Conv3x3]
    (reference: src/livae/model.py:355-373), and the ReLU after it where
    `relu`, as one half-resolution phase convolution and one epilogue (exact,
    boundaries included; ops.upconv.fused_upsample_reflect_conv)."""

    def __init__(self, in_channels: int, out_channels: int, relu: bool = False,
                 compute_dtype: str | None = None):
        super().__init__(in_channels, out_channels, 3)
        self.relu = relu
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_upsample_reflect_conv(*_cast(self, x), relu=self.relu)


class FusedConvPool(nn.Conv2d):
    """STN localisation block [Conv5x5(pad 2) -> ReLU -> MaxPool2] (reference:
    src/livae/model.py:203-214) as one half-resolution phase convolution and a
    phase max (exact; ops.upconv.fused_conv5_relu_maxpool). H and W even."""

    def __init__(self, in_channels: int, out_channels: int, compute_dtype: str | None = None):
        super().__init__(in_channels, out_channels, 5, padding=2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_conv5_relu_maxpool(*_cast(self, x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, stride=2) of [B, C, H, W]."""
    return F.max_pool2d(x, 2)


def reflection_pad_1(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad2d(1) of [B, C, H, W], written as slices (H, W >= 2)."""
    x = torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], 2)
    return torch.cat([x[..., 1:2], x, x[..., -2:-1]], 3)
