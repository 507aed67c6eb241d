"""Device idle (ms) an analysis pass leaves in the engine's own code: the
program's `encode.pass` and `encode.batch` outside their phases, and the
host copy at the end (`host_copy`), over the traced `encode.pass`es. Moves
encode_patches_per_s."""

from portbench.program_spans import ENCODE_ENGINE, idle_ms


def read(ctx):
    return idle_ms(ctx, ENCODE_ENGINE, per="encode.pass")
