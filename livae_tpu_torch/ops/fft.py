"""Frequency-domain filters (port of livae_tpu/ops/fft.py).

* The device filters: magnitude and phase spectra, [0, 1] normalisation and
  circular low-, high- and band-pass masks, in torch.fft at float32 /
  complex64 on the image's device. Each takes one 2-D image; a tensor stays
  on its device, anything else goes to `device` (CUDA unless asked
  otherwise). The radius is measured from (rows // 2, cols // 2), as
  fftshift centres the spectrum.
* `host_bandpass_normalize`: the dataset build's band-pass and min-max in
  float64 on the host (a copy of livae_tpu/ops/fft.py:109).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import fft as sfft

from ..device import resolve_device

__all__ = [
    "fft_spectra",
    "normalize_image",
    "lowpass_filter",
    "highpass_filter",
    "bandpass_filter",
    "radial_mask",
    "host_bandpass_normalize",
]


def _as_tensor(image, device=None) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to `device`."""
    if isinstance(image, torch.Tensor):
        return image
    return torch.tensor(np.asarray(image), device=resolve_device(device))


def _as_float_image(image, device=None) -> torch.Tensor:
    """A 2-D image as float32; ValueError on any other rank."""
    array = _as_tensor(image, device)
    if array.ndim != 2:
        raise ValueError(f"Expected a 2D array, got shape {tuple(array.shape)}")
    return array.float()


def radial_mask(
    shape: tuple[int, int],
    low_cutoff: float = 0.0,
    high_cutoff: float | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Bool mask of low_cutoff <= r (<= high_cutoff), r in float32 from
    (rows // 2, cols // 2)."""
    rows, cols = shape
    dev = resolve_device(device)
    y = torch.arange(rows, dtype=torch.float32, device=dev)[:, None] - rows // 2
    x = torch.arange(cols, dtype=torch.float32, device=dev)[None, :] - cols // 2
    radius = torch.sqrt(x * x + y * y)
    mask = radius >= low_cutoff
    if high_cutoff is not None:
        mask = mask & (radius <= high_cutoff)
    return mask


def fft_spectra(image, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Centred magnitude and phase spectra of a 2-D image."""
    f = torch.fft.fftshift(torch.fft.fft2(_as_float_image(image, device)))
    return f.abs(), f.angle()


def normalize_image(image, *, device=None) -> torch.Tensor:
    """Min-max to [0, 1] in float32; a constant input gives zeros."""
    array = _as_tensor(image, device).float()
    min_val = array.min()
    ptp = array.max() - min_val
    flat = ptp == 0.0  # no host read: the test stays on the device
    return torch.where(flat, torch.zeros_like(array),
                       (array - min_val) / torch.where(flat, torch.ones_like(ptp), ptp))


def _masked_fft_filter(array: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    f = torch.fft.fftshift(torch.fft.fft2(array))
    return torch.fft.ifft2(torch.fft.ifftshift(f * mask)).real


def lowpass_filter(image, cutoff_radius: float, *, device=None) -> torch.Tensor:
    """Circular low-pass: keep r <= cutoff_radius."""
    array = _as_float_image(image, device)
    mask = radial_mask(array.shape, high_cutoff=float(cutoff_radius), device=array.device)
    return _masked_fft_filter(array, mask)


def highpass_filter(image, cutoff_radius: float, *, device=None) -> torch.Tensor:
    """Circular high-pass: keep r >= cutoff_radius."""
    array = _as_float_image(image, device)
    mask = radial_mask(array.shape, low_cutoff=float(cutoff_radius), device=array.device)
    return _masked_fft_filter(array, mask)


def bandpass_filter(image, low_cutoff: float, high_cutoff: float, *, device=None) -> torch.Tensor:
    """Annular band-pass: keep low_cutoff <= r <= high_cutoff. Raises
    ValueError if high_cutoff <= low_cutoff."""
    if high_cutoff <= low_cutoff:
        raise ValueError("high_cutoff must be greater than low_cutoff")
    array = _as_float_image(image, device)
    mask = radial_mask(array.shape, float(low_cutoff), float(high_cutoff), device=array.device)
    return _masked_fft_filter(array, mask)


def host_bandpass_normalize(image, low_cutoff: float = 20.0, high_cutoff: float = 100.0):
    """Annular FFT band-pass (radius from (rows//2, cols//2)), then min-max to
    [0, 1] (a constant result -> zeros), in float64 on the host."""
    if high_cutoff <= low_cutoff:
        raise ValueError("high_cutoff must be greater than low_cutoff")
    array = np.asarray(image, dtype=np.float64)
    if array.ndim != 2:
        raise ValueError(f"Expected a 2D array, got shape {array.shape}")
    rows, cols = array.shape
    cy, cx = rows // 2, cols // 2
    y = np.arange(rows)[:, None] - cy
    x = np.arange(cols)[None, :] - cx
    r = np.sqrt(x * x + y * y)
    mask = (r >= low_cutoff) & (r <= high_cutoff)
    f = sfft.fftshift(sfft.fft2(array))
    out = np.real(sfft.ifft2(sfft.ifftshift(f * mask)))
    mn, ptp = out.min(), np.ptp(out)
    if ptp == 0.0:
        return np.zeros_like(out)
    return (out - mn) / ptp
