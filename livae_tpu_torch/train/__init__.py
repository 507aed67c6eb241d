"""Optimizers and the train / eval / encode steps."""
