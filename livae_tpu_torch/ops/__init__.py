"""Tensor ops of the port: the rot3 kernels, resampling and host preprocessing."""
