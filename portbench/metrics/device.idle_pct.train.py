"""Share of the traced train window (steps, host read, eval) in which no
device operation ran. Moves train_patches_per_s."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
