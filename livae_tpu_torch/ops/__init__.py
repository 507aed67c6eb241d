"""Tensor ops of the port: the rot3 and shear kernels, resampling, FFT
filters, peaks and the lattice."""

from . import fft, lattice, peaks, resample

__all__ = ["fft", "lattice", "peaks", "resample"]
