"""Device idle (ms) a train step leaves in the model's forward and backward
(the program's spans `forward`, `backward`), over the traced `train.step`s.
Moves train_patches_per_s."""

from portbench.program_spans import MODEL, idle_ms


def read(ctx):
    return idle_ms(ctx, MODEL, per="train.step", within="train.step")
