"""Device kernels a train step launches: the kernels of the traced window
that start from the first step call until the drain after the last one
returns, over the steps. Moves train_patches_per_s."""

from portbench.readers import kernels_between


def read(ctx):
    steps, drain = ctx.trace.spans_named("step"), ctx.trace.spans_named("drain")
    n = kernels_between(ctx.trace, steps[0][1], drain[0][2]) if steps and drain else None
    return None if n is None else n / len(steps)
