"""Device idle (ms) an analysis batch leaves while the program uploads its
site indices and extracts its patches (the program's spans `indices`,
`extract` and the extraction's children), over the traced `encode.batch`es.
Moves encode_patches_per_s."""

from portbench.program_spans import EXTRACTION, idle_ms


def read(ctx):
    return idle_ms(ctx, EXTRACTION, per="encode.batch", within="encode.batch")
