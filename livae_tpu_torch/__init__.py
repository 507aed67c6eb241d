"""PyTorch/CUDA port of livae_tpu, the rVAE framework for atomic-lattice analysis.

`livae_tpu/` (JAX) stays the reference; this package is its port for an
NVIDIA H100, checked against it module by module (tests/test_torch_*.py).
Layout is NCHW. Every entry point runs on CUDA unless the caller passes
`device="cpu"`; with no GPU and no device asked for, it raises.

The fused 3-shear rotation (ops/rot3.py) and the single fractional shift
(ops/shear.py) run as hand-written CUDA kernels (ops/csrc/) on CUDA tensors
and as their plain PyTorch versions on CPU tensors. Importing the package
builds nothing: the kernels are compiled at their first launch (ops/_build.py).

The public surface is the JAX package's (livae_tpu/__init__.py), name for
name, plus `resolve_device`.
"""

from .data.datasets import (
    AdaptiveLatticeDataset,
    PairedAdaptiveLatticeDataset,
    PatchDataset,
    default_transform,
)
from .data.h5 import load_image_from_h5
from .device import resolve_device
from .losses import (
    circular_distance,
    cycle_consistency_loss,
    rotation_diversity_loss,
    rvae_loss,
    vae_loss,
)
from .metrics import (
    compute_all_metrics,
    compute_atom_detection_metrics,
    compute_latent_metrics,
    compute_psnr,
    compute_reconstruction_metrics,
    compute_ssim,
)
from .models.rvae import RVAE, Decoder, Encoder, RotationSTN
from .models.vae import VAE, VAEDecoder, VAEEncoder
from .ops.fft import (
    bandpass_filter,
    fft_spectra,
    highpass_filter,
    lowpass_filter,
    normalize_image,
)
from .ops.lattice import estimate_lattice_constant, generate_lattice_grid
from .train.engine import (
    MetricLogger,
    evaluate,
    evaluate_rotation_invariance,
    evaluate_rvae,
    log_reconstructions_tensorboard,
    log_scalar_metrics_tensorboard,
    rotate_to_canonical,
    train_one_epoch,
    train_rvae_one_epoch,
)
from .utils.checkpoint import clean_state_dict

__version__ = "0.1.0"

__all__ = [
    # Data
    "PatchDataset",
    "AdaptiveLatticeDataset",
    "PairedAdaptiveLatticeDataset",
    "default_transform",
    # Filtering
    "normalize_image",
    "bandpass_filter",
    "fft_spectra",
    "lowpass_filter",
    "highpass_filter",
    # Losses
    "vae_loss",
    "rvae_loss",
    "circular_distance",
    "rotation_diversity_loss",
    "cycle_consistency_loss",
    # Models
    "VAE",
    "VAEEncoder",
    "VAEDecoder",
    "RVAE",
    "Encoder",
    "Decoder",
    "RotationSTN",
    # Training
    "train_one_epoch",
    "evaluate",
    "train_rvae_one_epoch",
    "evaluate_rvae",
    "evaluate_rotation_invariance",
    "rotate_to_canonical",
    "log_reconstructions_tensorboard",
    "log_scalar_metrics_tensorboard",
    "MetricLogger",
    # Metrics
    "compute_psnr",
    "compute_ssim",
    "compute_reconstruction_metrics",
    "compute_latent_metrics",
    "compute_atom_detection_metrics",
    "compute_all_metrics",
    # Utils
    "load_image_from_h5",
    "estimate_lattice_constant",
    "generate_lattice_grid",
    "clean_state_dict",
    # Device
    "resolve_device",
]
