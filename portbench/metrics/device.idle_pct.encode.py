"""Share of the traced analysis passes in which no device operation ran.
Moves encode_patches_per_s."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
