"""Device idle (ms) a train step leaves while the program draws the step's
augmentation and extracts its batch (the program's spans `draws`, `extract`
and the extraction's `crop`, `resample`, `rotate`, `normalize`), over the
traced `train.step`s. Moves train_patches_per_s."""

from portbench.program_spans import EXTRACTION, idle_ms


def read(ctx):
    return idle_ms(ctx, EXTRACTION, per="train.step", within="train.step")
