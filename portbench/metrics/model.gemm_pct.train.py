"""Share (%) of the traced window's device busy time in the matrix-product
kernels the model's binding names as its operation "gemm" (cuBLAS's and
CUTLASS's, by kernel name): how much of the step is matrix products, against
the elementwise and memory passes around them (bias, the latent's broadcast,
tanh and their backward). Moves train_patches_per_s."""

from portbench.readers import kernel_patterns, mapped_time_us
from portbench.trace import busy_us


def read(ctx):
    if not ctx.trace.ops or "gemm" not in kernel_patterns():
        return None
    busy = busy_us(ctx.trace)
    return 100.0 * mapped_time_us(ctx.trace, {"gemm"}) / busy if busy > 0 else None
