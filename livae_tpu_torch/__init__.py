"""PyTorch/CUDA port of livae_tpu, the rVAE framework for atomic-lattice analysis.

`livae_tpu/` (JAX) stays the reference; this package is its port for an
NVIDIA H100, checked against it module by module (tests/test_torch_*.py).
Layout is NCHW. Every entry point runs on CUDA unless the caller passes
`device="cpu"`; with no GPU and no device asked for, it raises.

The fused 3-shear rotation (ops/rot3.py) runs as hand-written CUDA kernels
(ops/csrc/rot3.cu) on CUDA tensors and as its plain PyTorch version on CPU
tensors.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
