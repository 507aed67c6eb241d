"""Device idle (ms) a train step leaves in the engine's own code: the
program's `train.step` outside its phases, and the metrics' accumulator
(`metrics`), over the traced `train.step`s. Moves train_patches_per_s."""

from portbench.program_spans import TRAIN_ENGINE, idle_ms


def read(ctx):
    return idle_ms(ctx, TRAIN_ENGINE, per="train.step", within="train.step")
