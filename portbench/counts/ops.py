"""What a unit of work computes: the bytes each hand-written operation
(rot3, the decoder epilogue U, the STN phase max P) must move, the FLOPs of
a convolution and a dense layer, and a model's FLOPs, which its binding
(models/<model>.py) counts from its layers.

Bytes count each input read once and each output written once, as the
port's on-card checks count them. FLOPs count the model's mathematics, two
per multiply-add: convolutions, transposed convolutions and dense layers,
forward, and for training the weight gradients of every layer and the data
gradients of every layer whose input needs one.
"""

from __future__ import annotations

import json
from pathlib import Path

from .. import spec

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def aligned_margin(size: int) -> int:
    return (-(-(size + 2 * (size // 4)) // 128) * 128 - size) // 2


def rot3_bytes(B: int, P: int, elem: int, direction: str, with_dx: bool = True) -> int:
    """x (and g) read, out (or dx) written, at `elem` bytes; the f32 shift
    tables d_row, d_col [B, P] read (and their gradients written)."""
    n, dl = B * P * P, 4 * B * P
    if direction == "fwd":
        return 2 * n * elem + 2 * dl
    return (3 if with_dx else 2) * n * elem + 4 * dl


def upconv_bytes(kind: str, B: int, H: int, W: int, C: int, elem: int, relu: bool = True) -> int:
    """U (one decoder stage's epilogue, input [B, 4C, H, W] phases) and P
    (one STN block's phase max over [B, 4C, H/2, W/2]), forward and backward."""
    if kind == "upconv_fwd":  # y, the used half of the edge lines, bias in; out
        return elem * (2 * B * 4 * C * H * W + B * 6 * C * (H + W) + C)
    if kind == "upconv_bwd":  # g, out (the ReLU's mask) in; g_y, g_qr, g_qc out
        return elem * ((3 if relu else 2) * B * 4 * C * H * W + B * 12 * C * (H + W))
    h, w = H // 2, W // 2
    if kind == "phasemax_fwd":  # y, bias in; out and the uint8 winner map
        return elem * (B * 4 * C * h * w + C + B * C * h * w) + B * C * h * w
    return elem * (B * C * h * w + B * 4 * C * h * w) + B * C * h * w  # g, win in; g_y


def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    return 2 * cin * cout * k * k * hout * wout


def dense_flops(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def forward_flops(model: str, S: int, latent: int) -> int:
    """Forward FLOPs of one patch, as the model's binding counts them."""
    return spec.binding(model).forward_flops(S, latent)


def train_flops(model: str, S: int, latent: int) -> int:
    """FLOPs of one patch's training step, as the model's binding counts
    them: forward, weight gradients, and data gradients of every layer but
    those fed by data."""
    return spec.binding(model).train_flops(S, latent)
