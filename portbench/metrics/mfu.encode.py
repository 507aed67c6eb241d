"""The model's forward FLOPs over every site of the measured window's passes
over the window's seconds and the peak of the stated convolution precision
(TF32). Moves encode_patches_per_s."""

from portbench.counts.ops import forward_flops
from portbench.readers import mfu_pct


def read(ctx):
    cfg, w = ctx.config, ctx.window
    if not ctx.trace.ops:  # no device seen: no share of its peak
        return None
    flops = w["passes"] * w["sites"] * forward_flops(cfg["model"], cfg["patch_size"], cfg["latent_dim"])
    return mfu_pct(flops, w["seconds"], cfg["precision"]["analyze"]["conv"])
