"""Device idle (ms) an analysis batch leaves in the model's forward (the
program's span `forward`), over the traced `encode.batch`es. Moves
encode_patches_per_s."""

from portbench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("forward",), per="encode.batch", within="encode.batch")
