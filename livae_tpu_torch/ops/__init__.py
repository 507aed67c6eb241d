"""Tensor ops of the port: the rot3, shear and upconv kernels, resampling, FFT
filters, peaks and the lattice."""

from . import fft, lattice, peaks, resample, upconv

__all__ = ["fft", "lattice", "peaks", "resample", "upconv"]
