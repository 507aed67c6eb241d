"""The hand-written operations of the traced analysis passes (two rot3
forwards, four U forwards, two P forwards a batch, float32): the least time
their bytes take at 3.35 TB/s over the device time of the kernels mapped
to them. Moves encode_patches_per_s."""

from portbench.readers import encode_work, roofline_pct


def read(ctx):
    return roofline_pct(ctx.trace, encode_work(ctx))
