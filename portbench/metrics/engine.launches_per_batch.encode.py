"""Device kernels an analysis batch launches: the kernels that start inside
the traced passes (each ends in its host copy), over their batches, the
ragged tail counted as a batch. Moves encode_patches_per_s."""

from portbench.readers import kernels_between


def read(ctx):
    passes = ctx.trace.spans_named("pass")
    counts = [kernels_between(ctx.trace, a, b) for _, a, b in passes]
    if not counts or None in counts:
        return None
    return sum(counts) / (len(passes) * len(ctx.trace.info["batches"]))
