"""The rotationally invariant VAE: the port's `RVAE` with its fused paired
train step and eval, the plain reference in `reference/rvae.py`, and its
counts (the STN, the trunk and the decoder; rot3, the decoder epilogue U and
the STN phase max P as its hand-written operations)."""

from __future__ import annotations

import torch

from portbench.counts.ops import aligned_margin, conv_flops, dense_flops, rot3_bytes, upconv_bytes
from portbench.loops.common import augment_draws
from portbench.reference import rvae as ref

PAIRED = True
LATENT_BIASES = {"mu": "encoder.fc_mu.bias", "logvar": "encoder.fc_logvar.bias"}
draws = augment_draws


# --- program side ---

def train_model(cfg: dict, device) -> torch.nn.Module:
    from livae_tpu_torch.models.rvae import RVAE

    return RVAE(cfg["latent_dim"], 1, cfg["patch_size"], cfg["precision"]["compute_dtype"],
                device=device, generator=torch.Generator().manual_seed(0),
                fast_resample=cfg["fast_resample"])


def train_step(model, optimizer, scheduler, augment, cfg: dict, **kw):
    from livae_tpu_torch.train import engine

    loss = cfg["loss"]
    step = engine.make_fused_rvae_train_step(
        model, optimizer, cfg=augment, use_diversity=loss["use_diversity"],
        canonical_weight=loss["canonical_weight"], grad_max_norm=cfg["grad_max_norm"],
        scheduler=scheduler, **kw)
    evaluate = engine.make_fused_rvae_eval(
        model, cfg=augment, use_diversity=loss["use_diversity"],
        canonical_weight=loss["canonical_weight"], **kw)
    return step, evaluate


def analysis_model(cfg: dict, device):
    """`RVAE(latent, patch)` as `visualizations.load_model` builds it:
    float32 tensors, the fast rotation."""
    from livae_tpu_torch.models.rvae import RVAE

    model = RVAE(latent_dim=cfg["latent_dim"], patch_size=cfg["patch_size"], device=device,
                 generator=torch.Generator().manual_seed(0))
    return model, True


# --- reference side ---

def reference_loss(p, batch, eps, precision, loss_cfg: dict):
    x, x_rot, angle = batch
    return ref.paired_loss(p, x, x_rot, angle, eps, precision, loss_cfg)


def reference_stats(p, x, eps, precision) -> dict:
    mu, logvar, err, theta, cond = ref.batch_stats(p, x, eps, precision)
    return {"mu": mu, "logvar": logvar, "rec_err": err, "theta": theta, "cond": cond}


# --- counts ---

def decoder_stages(S: int) -> list[tuple[int, int, int, int, bool]]:
    """(C_in, H, W, C_out, relu) of the four decoder stages at patch S."""
    side = S // 16
    return [(256, side, side, 128, True), (128, 2 * side, 2 * side, 64, True),
            (64, 4 * side, 4 * side, 32, True), (32, 8 * side, 8 * side, 1, False)]


def stn_blocks(S: int) -> list[tuple[int, int, int, int]]:
    """(C_in, H, W, C_out) of the two localisation blocks."""
    return [(1, S, S, 16), (16, S // 2, S // 2, 32)]


def batch_ops(S: int, padding: int, B: int, elem: int, *, train: bool, paired: bool,
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


PHASES = {"train": dict(train=True, paired=True, augmented_rotation=True),
          "eval": dict(train=False, paired=True, augmented_rotation=True),
          "encode": dict(train=False, paired=False, augmented_rotation=False)}


def kernel_ops(phase: str, cfg: dict, padding: int, B: int, elem: int) -> list[tuple[str, int]]:
    """Training and eval batches are paired and rotated by the augmentation;
    the analysis' are neither."""
    return batch_ops(cfg["patch_size"], padding, B, elem, **PHASES[phase])


def trunk_flops(S: int, latent: int) -> int:
    """The encoder trunk the rVAE and the VAE share: four stride-2 4x4
    convolutions and the mu and logvar heads."""
    widths, f = (1, 32, 64, 128, 256), 0
    for i in range(4):
        f += conv_flops(widths[i], widths[i + 1], 4, S >> (i + 1), S >> (i + 1))
    return f + 2 * dense_flops(256 * (S // 16) ** 2, latent)


def _stn(S: int) -> int:
    f = sum(conv_flops(cin, cout, 5, H, W) for cin, H, W, cout in stn_blocks(S))
    return f + dense_flops(32 * (S // 4) ** 2, 32) + dense_flops(32, 2)


def _decoder(S: int, latent: int) -> int:
    f = dense_flops(latent, 256 * (S // 16) ** 2)
    return f + sum(conv_flops(cin, cout, 3, 2 * H, 2 * W)
                   for cin, H, W, cout, _ in decoder_stages(S))


def forward_flops(S: int, latent: int) -> int:
    """The patch is localised once."""
    return _stn(S) + trunk_flops(S, latent) + _decoder(S, latent)


def train_flops(S: int, latent: int) -> int:
    """Forward, weight gradients, and data gradients of every layer but
    those fed by data: the patch and its rotated copy are localised, and the
    first STN convolution sees data."""
    fwd = 2 * _stn(S) + trunk_flops(S, latent) + _decoder(S, latent)
    return 3 * fwd - 2 * conv_flops(1, 16, 5, S, S)
