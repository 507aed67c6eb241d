"""Host site tables and on-device patch extraction."""

from .datasets import (
    AdaptiveLatticeDataset,
    PairedAdaptiveLatticeDataset,
    PatchDataset,
    default_transform,
)
from .h5 import load_image_from_h5
from .pipeline import AugmentConfig, extract_batch, extract_batch_paired

__all__ = [
    "AdaptiveLatticeDataset",
    "AugmentConfig",
    "PairedAdaptiveLatticeDataset",
    "PatchDataset",
    "default_transform",
    "extract_batch",
    "extract_batch_paired",
    "load_image_from_h5",
]
