"""rVAE model family of the port (NCHW)."""
