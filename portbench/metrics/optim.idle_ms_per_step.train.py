"""Device idle (ms) a train step leaves in the losses, the gradient clip and
the optimizer's and schedule's step (the program's spans `loss`, `clip`,
`optimizer`), over the traced `train.step`s. Moves train_patches_per_s."""

from portbench.program_spans import OPTIM, idle_ms


def read(ctx):
    return idle_ms(ctx, OPTIM, per="train.step", within="train.step")
