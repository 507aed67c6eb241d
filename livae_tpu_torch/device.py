"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device; anything else is taken as asked.

    Raises RuntimeError when CUDA is wanted (by default or by name) and no GPU
    is present: the port never carries on silently on the CPU. Pass
    `device="cpu"` to run the plain PyTorch versions on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "livae_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
