"""Dataset classes (port of livae_tpu/data/datasets.py).

Build time, on the host once per frame: bandpass(20, 100) + normalise,
lattice-constant estimate (torch.fft on the dataset's device), then either
peak detection and adaptive lattice extrapolation (`AdaptiveLatticeDataset`,
`PairedAdaptiveLatticeDataset`) or the detected atoms alone (`PatchDataset`)
give a flat site table. Run time: the padded frames and the site table live
on the device, and `sample_batch` / `batch_at` / `iter_epoch` and the fused
train/eval/encode steps (`device_site_table`) extract batches there.

Randomness comes from a `torch.Generator` on the dataset's device. The
unpaired classes extract without augmentation when `batch_at` gets none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fft import host_bandpass_normalize
from ..ops.lattice import build_adaptive_lattice, estimate_lattice_constant
from ..ops.peaks import get_clean_peaks
from ..tracing import span
from .pipeline import AugmentConfig, extract_batch, extract_batch_paired, pad_frames

__all__ = [
    "default_transform",
    "PatchDataset",
    "AdaptiveLatticeDataset",
    "PairedAdaptiveLatticeDataset",
]

# scale 0.9-1.1, flips p=0.5, jitter +-4, no rotation of the patch itself
default_transform = AugmentConfig()


class _SiteDatasetBase:
    """Frame preprocessing, the site table and the device batch machinery.

    Built on `device` (CUDA unless `device="cpu"`).
    """

    _NORMALIZE = True

    def __init__(self, images, patch_size, padding, transform, device=None):
        if transform is not None and not isinstance(transform, AugmentConfig):
            raise TypeError("transform must be an AugmentConfig (e.g. default_transform) or None")
        self.device = resolve_device(device)
        self.patch_size = int(patch_size)
        self.padding = int(padding)
        self.transform = transform

        frames = []
        self.lattice_spacings: list[float] = []
        for img in images:
            filtered = host_bandpass_normalize(np.asarray(img), 20, 100)
            frames.append(filtered)
            self.lattice_spacings.append(estimate_lattice_constant(filtered, device=self.device))
        self.images = frames  # host copies

        shapes = {f.shape for f in frames}
        if len(shapes) != 1:
            raise ValueError(f"All frames must share a shape, got {shapes}")

        self._build_sites()

        roi = self.patch_size + 2 * self.padding + 16
        self._margin = roi // 2 + 8
        self.frames_padded = pad_frames(
            torch.as_tensor(np.stack(frames), dtype=torch.float32, device=self.device),
            self._margin,
        )
        counts = [len(c) for c in self.sample_coords]
        self._counts = counts
        self._img_idx = (
            np.concatenate([np.full(n, i, dtype=np.int64) for i, n in enumerate(counts)])
            if counts else np.zeros(0, np.int64)
        )
        self._coords_flat = (
            np.concatenate(self.sample_coords, axis=0).astype(np.float32)
            if counts else np.zeros((0, 2), np.float32)
        )
        self._img_idx_dev = torch.as_tensor(self._img_idx, device=self.device)
        self._coords_dev = torch.as_tensor(self._coords_flat, device=self.device)

    def _build_sites(self):  # pragma: no cover
        raise NotImplementedError

    # --- indexing API ---
    def __len__(self) -> int:
        return int(sum(self._counts))

    def _locate(self, idx: int) -> int:
        if idx < 0 or idx >= len(self):
            raise IndexError(f"Index {idx} out of range for dataset of size {len(self)}")
        return idx

    def _item_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(np.random.randint(0, 2**31)))

    def __getitem__(self, idx: int):
        idx = self._locate(int(idx))
        gen = self._item_generator() if self.transform else None
        return self.batch_at([idx], gen)[0].cpu().numpy()

    # --- device batch API ---
    def _indices(self, indices) -> torch.Tensor:
        return torch.as_tensor(indices, dtype=torch.long, device=self.device)

    def _extract(self, idx: torch.Tensor, generator):
        return extract_batch(
            self.frames_padded, self._img_idx_dev[idx], self._coords_dev[idx],
            self.patch_size, self.padding, normalize=self._NORMALIZE, margin=self._margin,
            cfg=self.transform if generator is not None else None, generator=generator,
        )

    def sample_batch(self, generator: torch.Generator, batch_size: int):
        """Uniformly sample an augmented device batch."""
        idx = torch.randint(0, len(self), (batch_size,), generator=generator, device=self.device)
        return self._extract(idx, generator)

    def batch_at(self, indices, generator: torch.Generator | None = None):
        """Extract specific sites; no generator means no augmentation (the
        encode path)."""
        with span("indices"):
            idx = self._indices(indices)
        with span("extract"):
            return self._extract(idx, generator)

    def iter_epoch(self, generator: torch.Generator, batch_size: int, drop_last: bool = True):
        """Shuffled epoch iterator of device batches."""
        n = len(self)
        perm = torch.randperm(n, generator=generator, device=self.device)
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(n_batches):
            yield self._extract(perm[b * batch_size : (b + 1) * batch_size], generator)

    def epoch_index_batches(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """[steps, batch_size] shuffled site indices for one epoch (drop last)."""
        n = len(self)
        steps = n // batch_size
        perm = torch.randperm(n, generator=generator, device=self.device)
        return perm[: steps * batch_size].reshape(steps, batch_size)

    @property
    def device_site_table(self):
        """(frames_padded, img_idx, coords, margin) for the fused steps."""
        return self.frames_padded, self._img_idx_dev, self._coords_dev, self._margin


class AdaptiveLatticeDataset(_SiteDatasetBase):
    """Adaptive lattice sites (atoms and vacancies) with augmentation.

    Defaults padding=48, detection_threshold=0.6. `normalize=False` skips the
    per-patch min-max. `device_peaks=True` detects the atoms on the dataset's
    device (`ops.lattice.detect_atoms_device`) instead of the host's maximum
    filter.
    """

    def __init__(
        self,
        images,
        patch_size: int,
        padding: int = 48,
        transform: AugmentConfig | None = default_transform,
        detection_threshold: float = 0.6,
        device_peaks: bool = False,
        normalize: bool = True,
        *,
        device=None,
    ):
        self.detection_threshold = detection_threshold
        self.device_peaks = device_peaks
        self._NORMALIZE = bool(normalize)
        super().__init__(images, patch_size, padding, transform, device)

    @property
    def normalize(self) -> bool:
        return self._NORMALIZE

    def _build_sites(self):
        self.sample_coords, self.labels = [], []
        for img, spacing in zip(self.images, self.lattice_spacings):
            sites, labels, _ = build_adaptive_lattice(
                img, self.patch_size, self.padding, self.detection_threshold,
                lattice_spacing=spacing, device_peaks=self.device_peaks, device=self.device,
            )
            n_atoms = int((labels == 1).sum())
            print(
                f"Adaptive lattice: {len(sites)} unique sites - "
                f"{n_atoms} with atoms, {len(sites) - n_atoms} empty sites"
            )
            self.sample_coords.append(sites)
            self.labels.append(labels)


class PairedAdaptiveLatticeDataset(AdaptiveLatticeDataset):
    """(patch, rotated_patch, angle) triplets for STN cycle training."""

    def _extract(self, idx: torch.Tensor, generator):
        if generator is None:  # a fixed stream, as the JAX package's key(0)
            generator = torch.Generator(device=self.device).manual_seed(0)
        return extract_batch_paired(
            self.frames_padded, self._img_idx_dev[idx], self._coords_dev[idx], generator,
            self.patch_size, self.padding, cfg=self.transform, margin=self._margin,
            normalize=self._NORMALIZE,
        )

    def __getitem__(self, idx: int):
        idx = self._locate(int(idx))
        patch, rotated, angle = self.batch_at([idx], self._item_generator())
        return patch[0].cpu().numpy(), rotated[0].cpu().numpy(), float(angle[0])


class PatchDataset(_SiteDatasetBase):
    """Detected-atom patches with rotation augmentation and no per-patch
    min-max (the frames are normalised already). Default padding=4."""

    _NORMALIZE = False

    def __init__(
        self,
        images,
        patch_size: int,
        padding: int = 4,
        transform: AugmentConfig | None = default_transform,
        *,
        device=None,
    ):
        if isinstance(transform, AugmentConfig):
            transform = dataclasses.replace(transform, rotation=True)
        super().__init__(images, patch_size, padding, transform, device)

    def plot_peaks(
        self,
        img_idx: int,
        size: int | None = None,
        offset: tuple[int, int] = (0, 0),
        save_path: str | None = None,
    ) -> None:
        """Plot the detected atoms over the filtered image: an optional square
        crop of `size` pixels at `offset` (y, x), red scatter, axes off.
        `save_path` writes a PNG instead of showing."""
        import matplotlib

        if save_path is not None:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        img = self.images[img_idx]
        coords = np.asarray(self.atom_coords[img_idx])
        if size is not None:
            y_off, x_off = offset
            img = img[y_off : y_off + size, x_off : x_off + size]
            keep = (
                (coords[:, 0] >= y_off)
                & (coords[:, 0] < y_off + size)
                & (coords[:, 1] >= x_off)
                & (coords[:, 1] < x_off + size)
            )
            coords = coords[keep] - np.array([y_off, x_off])
        plt.figure(figsize=(6, 6))
        plt.imshow(img, cmap="gray")
        if len(coords):
            plt.scatter(coords[:, 1], coords[:, 0], s=30, c="red", marker="o", alpha=0.8)
        plt.axis("off")
        if save_path is not None:
            plt.savefig(save_path, bbox_inches="tight", dpi=120)
            plt.close()
        else:
            plt.show()

    def _build_sites(self):
        self.sample_coords = []
        self.atom_coords = self.sample_coords  # the same list under the older name
        for img, spacing in zip(self.images, self.lattice_spacings):
            coords = get_clean_peaks(img, min_distance=int(spacing * 0.15))
            half = self.patch_size // 2 + self.padding
            if len(coords):
                mask = (
                    (coords[:, 0] >= half)
                    & (coords[:, 0] <= img.shape[0] - half)
                    & (coords[:, 1] >= half)
                    & (coords[:, 1] <= img.shape[1] - half)
                )
                print(f"Detected {len(coords)} atoms, {int(mask.sum())} after edge exclusion.")
                coords = coords[mask]
            self.sample_coords.append(np.asarray(coords, dtype=np.float64).reshape(-1, 2))
