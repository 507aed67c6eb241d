"""The model FLOPs of the measured window's train steps (counts/ops.py:
forward, weight and data gradients) over the window's seconds and the card's
bf16 peak. Moves train_patches_per_s."""

from portbench.counts.ops import train_flops
from portbench.readers import mfu_pct


def read(ctx):
    cfg, w = ctx.config, ctx.window
    if not ctx.trace.ops:  # no device seen: no share of its peak
        return None
    flops = w["steps"] * w["batch"] * train_flops(cfg["model"], cfg["patch_size"], cfg["latent_dim"])
    return mfu_pct(flops, w["seconds"], cfg["precision"]["compute_dtype"])
