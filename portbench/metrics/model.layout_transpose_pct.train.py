"""Share of the traced window's device time in cuDNN's NCHW <-> NHWC layout
transposes, by kernel name (counts/kernel_map.json). Moves train_patches_per_s."""

import re

from portbench.readers import KERNEL_MAP


def read(ctx):
    total = sum(b - a for _, a, b in ctx.trace.ops)
    if total <= 0:
        return None
    pats = [re.compile(p) for p in KERNEL_MAP["layout_transpose"]]
    t = sum(b - a for n, a, b in ctx.trace.ops if any(p.search(n) for p in pats))
    return 100.0 * t / total
