"""Seconds of the first calls after the model is built: the first train
steps and eval (or the first analysis pass), where cuDNN makes its plans and
the kernel libraries load. The benchmark's host span. Moves setup_s."""


def read(ctx):
    return ctx.spans.seconds("first_calls") or None
