"""Plain reference of the VAE (upstream LI-VAE `model.py:9-182`) and its
training objective, as functions of a parameter dict keyed by the upstream
state-dict names. Convolutions run at precision["conv"] (see
common.operands); dense layers, the loss and the optimizer in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C
from .rvae import trunk


def decode(p, z, precision):
    """fc, ReLU, four ConvTranspose2d(k 4, stride 2, pad 1) with ReLU between, sigmoid."""
    side = int(round((p["decoder.fc.weight"].shape[0] // 256) ** 0.5))
    h = F.relu(F.linear(z, p["decoder.fc.weight"].float(), p["decoder.fc.bias"].float()))
    h = h.reshape(z.shape[0], 256, side, side)
    for i in (0, 2, 4, 6):
        h = C.conv_transpose2d(h, p[f"decoder.deconv_layers.{i}.weight"],
                               p[f"decoder.deconv_layers.{i}.bias"], precision, stride=2,
                               padding=1)
        if i < 6:
            h = F.relu(h)
    return torch.sigmoid(h.float())


def loss(p, x, eps, precision, loss_cfg: dict):
    """Mean-reduced MSE + beta x mean KL, and its terms."""
    mu, logvar = trunk(p, x, precision["conv"])
    recon = decode(p, mu + eps * torch.exp(0.5 * logvar), precision["conv"])
    rl = torch.mean((recon - x) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return rl + loss_cfg["beta"] * kl, {"recon_loss": rl, "kld_loss": kl}
