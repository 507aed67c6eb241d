"""rVAE model family of the port (NCHW), its half-resolution layers, and
spatial-VAE's coordinate-decoder rVAE."""

from .layers import FusedConvPool, FusedUpConv
from .rvae import RVAE, Decoder, Encoder, RotationSTN
from .spatial_vae import SpatialVAE
from .vae import VAE, VAEDecoder, VAEEncoder

__all__ = ["RVAE", "Decoder", "Encoder", "RotationSTN", "SpatialVAE", "VAE", "VAEDecoder",
           "VAEEncoder", "FusedConvPool", "FusedUpConv"]
