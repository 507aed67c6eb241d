"""Paired adaptive-lattice dataset (port of livae_tpu/data/datasets.py:44-260).

Build time, on the host once per frame: bandpass(20, 100) + normalise,
lattice-constant estimate (torch.fft on the dataset's device), peak
detection and adaptive lattice extrapolation give a flat site table. Run
time: the padded frames and the site table live on the device, and the
fused train/eval/encode steps extract batches there
(`device_site_table`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fft import host_bandpass_normalize
from ..ops.lattice import build_adaptive_lattice, estimate_lattice_constant
from .pipeline import AugmentConfig, extract_batch_paired, pad_frames

__all__ = ["default_transform", "PairedAdaptiveLatticeDataset"]

# scale 0.9-1.1, flips p=0.5, jitter +-4, no rotation of the patch itself
default_transform = AugmentConfig()


class PairedAdaptiveLatticeDataset:
    """(patch, rotated_patch, angle) triplets for STN cycle training.

    Built on `device` (CUDA unless `device="cpu"`). `normalize=False` skips
    the per-patch min-max.
    """

    def __init__(
        self,
        images,
        patch_size: int,
        padding: int = 48,
        transform: AugmentConfig | None = default_transform,
        detection_threshold: float = 0.6,
        normalize: bool = True,
        *,
        device=None,
    ):
        if transform is not None and not isinstance(transform, AugmentConfig):
            raise TypeError("transform must be an AugmentConfig or None")
        self.device = resolve_device(device)
        self.patch_size = int(patch_size)
        self.padding = int(padding)
        self.transform = transform
        self.detection_threshold = detection_threshold
        self.normalize = bool(normalize)

        frames = []
        self.lattice_spacings: list[float] = []
        for img in images:
            filtered = host_bandpass_normalize(np.asarray(img), 20, 100)
            frames.append(filtered)
            self.lattice_spacings.append(estimate_lattice_constant(filtered, device=self.device))
        self.images = frames
        shapes = {f.shape for f in frames}
        if len(shapes) != 1:
            raise ValueError(f"All frames must share a shape, got {shapes}")

        self.sample_coords, self.labels = [], []
        for img, spacing in zip(frames, self.lattice_spacings):
            sites, labels, _ = build_adaptive_lattice(
                img, self.patch_size, self.padding, detection_threshold,
                lattice_spacing=spacing,
            )
            n_atoms = int((labels == 1).sum())
            print(
                f"Adaptive lattice: {len(sites)} unique sites - "
                f"{n_atoms} with atoms, {len(sites) - n_atoms} empty sites"
            )
            self.sample_coords.append(sites)
            self.labels.append(labels)

        roi = self.patch_size + 2 * self.padding + 16
        self._margin = roi // 2 + 8
        self.frames_padded = pad_frames(
            torch.as_tensor(np.stack(frames), dtype=torch.float32, device=self.device),
            self._margin,
        )
        counts = [len(c) for c in self.sample_coords]
        self._img_idx = np.concatenate(
            [np.full(n, i, dtype=np.int64) for i, n in enumerate(counts)]
        )
        self._coords_flat = np.concatenate(self.sample_coords, axis=0).astype(np.float32)
        self._img_idx_dev = torch.as_tensor(self._img_idx, device=self.device)
        self._coords_dev = torch.as_tensor(self._coords_flat, device=self.device)

    def __len__(self) -> int:
        return len(self._img_idx)

    @property
    def device_site_table(self):
        """(frames_padded, img_idx, coords, margin) for the fused steps."""
        return self.frames_padded, self._img_idx_dev, self._coords_dev, self._margin

    def epoch_index_batches(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """[steps, batch_size] shuffled site indices for one epoch (drop last)."""
        n = len(self)
        steps = n // batch_size
        perm = torch.randperm(n, generator=generator, device=self.device)
        return perm[: steps * batch_size].reshape(steps, batch_size)

    def batch_at(self, indices, generator: torch.Generator):
        """Paired extraction of specific sites: (patch, rotated, angle)."""
        idx = torch.as_tensor(indices, dtype=torch.long, device=self.device)
        return extract_batch_paired(
            self.frames_padded, self._img_idx_dev[idx], self._coords_dev[idx], generator,
            self.patch_size, self.padding, cfg=self.transform, margin=self._margin,
            normalize=self.normalize,
        )
