"""The hand-written operations of the traced train steps and eval batches
(rot3, the decoder epilogue U, the STN phase max P, each way): the least
time their bytes take at 3.35 TB/s over the device time of the kernels
mapped to them. Moves train_patches_per_s."""

from portbench.readers import roofline_pct, train_work


def read(ctx):
    work = train_work(ctx)
    return roofline_pct(ctx.trace, work) if work else None
