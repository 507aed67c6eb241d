"""Host bandpass + normalisation for the dataset build (a copy of
`host_bandpass_normalize`, livae_tpu/ops/fft.py:109)."""

from __future__ import annotations

import numpy as np
from scipy import fft as sfft

__all__ = ["host_bandpass_normalize"]


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
