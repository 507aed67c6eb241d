"""rVAE model family of the port (NCHW), and its half-resolution layers."""

from .layers import FusedConvPool, FusedUpConv
from .rvae import RVAE, Decoder, Encoder, RotationSTN
from .vae import VAE, VAEDecoder, VAEEncoder

__all__ = ["RVAE", "Decoder", "Encoder", "RotationSTN", "VAE", "VAEDecoder", "VAEEncoder",
           "FusedConvPool", "FusedUpConv"]
