"""rVAE model family of the port (NCHW)."""

from .rvae import RVAE, Decoder, Encoder, RotationSTN
from .vae import VAE, VAEDecoder, VAEEncoder

__all__ = ["RVAE", "Decoder", "Encoder", "RotationSTN", "VAE", "VAEDecoder", "VAEEncoder"]
