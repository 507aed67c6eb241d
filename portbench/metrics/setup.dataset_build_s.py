"""Seconds of the dataset build (frames to the site table on the device),
the benchmark's host span around the dataset's constructor. Moves setup_s."""


def read(ctx):
    return ctx.spans.seconds("dataset_build") or None
