"""What a unit of work computes, from the configuration's shapes: the
hand-written operations (rot3, the decoder epilogue U, the STN phase max P)
with the bytes each must move, and the model's FLOPs.

Bytes count each input read once and each output written once, as the
port's on-card checks count them. FLOPs count the model's mathematics, two
per multiply-add: convolutions, transposed convolutions and dense layers,
forward, and for training the weight gradients of every layer and the data
gradients of every layer whose input needs one.
"""

from __future__ import annotations

import json
from pathlib import Path

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


def decoder_stages(S: int) -> list[tuple[int, int, int, int, bool]]:
    """(C_in, H, W, C_out, relu) of the four decoder stages at patch S."""
    side = S // 16
    return [(256, side, side, 128, True), (128, 2 * side, 2 * side, 64, True),
            (64, 4 * side, 4 * side, 32, True), (32, 8 * side, 8 * side, 1, False)]


def stn_blocks(S: int) -> list[tuple[int, int, int, int]]:
    """(C_in, H, W, C_out) of the two localisation blocks."""
    return [(1, S, S, 16), (16, S // 2, S // 2, 32)]


def rvae_ops(S: int, padding: int, B: int, elem: int, *, train: bool, paired: bool,
             augmented_rotation: bool) -> list[tuple[str, int]]:
    """(operation, bytes) of one rVAE batch of B: the extraction's rotation
    (paired batches), the STN's localisation on B (2B paired) and its
    rotation, the decoder's four stages, the inverse rotation; with `train`,
    the backward of each that has one (the STN's rotation without dx)."""
    canvas = S + 2 * aligned_margin(S)
    ops = []
    if augmented_rotation:
        P2 = S + 2 * padding
        ops.append(("rot3_fwd", rot3_bytes(B, P2 + 2 * (P2 // 6), elem, "fwd")))
    nb = 2 * B if paired else B
    for _, H, W, C in stn_blocks(S):
        ops.append(("phasemax_fwd", upconv_bytes("phasemax_fwd", nb, H, W, C, elem)))
        if train:
            ops.append(("phasemax_bwd", upconv_bytes("phasemax_bwd", nb, H, W, C, elem)))
    ops.append(("rot3_fwd", rot3_bytes(B, canvas, elem, "fwd")))
    if train:
        ops.append(("rot3_bwd", rot3_bytes(B, canvas, elem, "bwd", with_dx=False)))
    for _, H, W, C, relu in decoder_stages(S):
        ops.append(("upconv_fwd", upconv_bytes("upconv_fwd", B, H, W, C, elem, relu)))
        if train:
            ops.append(("upconv_bwd", upconv_bytes("upconv_bwd", B, H, W, C, elem, relu)))
    ops.append(("rot3_fwd", rot3_bytes(B, canvas, elem, "fwd")))
    if train:
        ops.append(("rot3_bwd", rot3_bytes(B, canvas, elem, "bwd", with_dx=True)))
    return ops


def _conv(cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    return 2 * cin * cout * k * k * hout * wout


def _dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def _trunk(S: int, latent: int) -> int:
    widths, f = (1, 32, 64, 128, 256), 0
    for i in range(4):
        f += _conv(widths[i], widths[i + 1], 4, S >> (i + 1), S >> (i + 1))
    return f + 2 * _dense(256 * (S // 16) ** 2, latent)


def _stn(S: int) -> int:
    f = sum(_conv(cin, cout, 5, H, W) for cin, H, W, cout in stn_blocks(S))
    return f + _dense(32 * (S // 4) ** 2, 32) + _dense(32, 2)


def _rvae_decoder(S: int, latent: int) -> int:
    f = _dense(latent, 256 * (S // 16) ** 2)
    return f + sum(_conv(cin, cout, 3, 2 * H, 2 * W) for cin, H, W, cout, _ in decoder_stages(S))


def _vae_decoder(S: int, latent: int) -> int:
    side, widths = S // 16, (256, 128, 64, 32, 1)
    f = _dense(latent, 256 * side * side)
    for i in range(4):  # a transposed conv: 2 x C_in x C_out x k^2 per input pixel
        f += 2 * widths[i] * widths[i + 1] * 16 * (side << i) ** 2
    return f


def forward_flops(model: str, S: int, latent: int) -> int:
    """Forward FLOPs of one patch (the rVAE localises it once)."""
    if model == "rvae":
        return _stn(S) + _trunk(S, latent) + _rvae_decoder(S, latent)
    if model == "vae":
        return _trunk(S, latent) + _vae_decoder(S, latent)
    raise ValueError(f"no FLOP count for model {model!r}")


def train_flops(model: str, S: int, latent: int) -> int:
    """FLOPs of one patch's training step: forward, weight gradients, and
    data gradients of every layer but those fed by data (the rVAE localises
    the patch and its rotated copy; the first STN convolution sees data, as
    the VAE's first trunk convolution does)."""
    if model == "rvae":
        fwd = 2 * _stn(S) + _trunk(S, latent) + _rvae_decoder(S, latent)
        fed_by_data = 2 * _conv(1, 16, 5, S, S)
    elif model == "vae":
        fwd = forward_flops("vae", S, latent)
        fed_by_data = _conv(1, 32, 4, S // 2, S // 2)
    else:
        raise ValueError(f"no FLOP count for model {model!r}")
    return 3 * fwd - fed_by_data
