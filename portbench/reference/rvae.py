"""Plain reference of the rotationally invariant VAE (upstream LI-VAE
`model.py:185-472`, with the rebuild's fast rotation), its paired training
step and its analysis pass, as functions of a parameter dict keyed by the
upstream state-dict names.

A precision is {"conv": ..., "io": ...}: the convolutions compute at
"conv" (see common.operands) and the rotations' inputs and outputs are
stored at "io" (common.io); dense layers, the rotations' arithmetic, the
losses and the optimizer are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C

TRUNK = ("encoder.conv_layers.0", "encoder.conv_layers.2", "encoder.conv_layers.4",
         "encoder.conv_layers.6")
STN = "encoder.rotation_stn.localization"
STAGES = ("decoder.deconv_layers.2", "decoder.deconv_layers.6", "decoder.deconv_layers.10",
          "decoder.deconv_layers.14")


def _lin(p, name, h):
    return F.linear(h, p[name + ".weight"].float(), p[name + ".bias"].float())


def localize(p, x, precision):
    """[B, 1, S, S] -> theta [B, 1]: two (conv 5x5, ReLU, max-pool 2) blocks,
    Linear-ReLU-Linear to (cos, sin), normalised, atan2."""
    h = x
    for i in (0, 3):
        h = C.conv2d(h, p[f"{STN}.{i}.weight"], p[f"{STN}.{i}.bias"], precision, padding=2)
        h = F.max_pool2d(F.relu(h), 2)
    vec = _lin(p, f"{STN}.9", F.relu(_lin(p, f"{STN}.7", h.flatten(1).float())))
    vec = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=1, keepdim=True), min=1e-6)
    return torch.atan2(vec[:, 1], vec[:, 0])[:, None]


@torch.no_grad()
def angle_condition(p, x):
    """[B, 1, S, S] -> [B]: how far rounding in the localisation can turn
    each patch's angle. The localisation is run a second time on the
    absolute values of its weights, biases and input (each ReLU and max-pool
    keeping the units the float32 pass keeps), which bounds every unit's
    rounding by its magnitude; the ratio of the (cos, sin) head's bound to
    the head's norm is the angle's condition number: an angle is determined
    to about the unit roundoff times it."""
    h, m = x.float(), x.float().abs()
    for i in (0, 3):
        w, b = p[f"{STN}.{i}.weight"].float(), p[f"{STN}.{i}.bias"].float()
        h = F.conv2d(h, w, b, padding=2)
        m = F.conv2d(m, w.abs(), b.abs(), padding=2) * (h > 0)
        h, pick = F.max_pool2d(F.relu(h), 2, return_indices=True)
        m = m.flatten(2).gather(2, pick.flatten(2)).reshape(h.shape)
    h, m = h.flatten(1), m.flatten(1)
    w7, b7 = p[f"{STN}.7.weight"].float(), p[f"{STN}.7.bias"].float()
    h = F.linear(h, w7, b7)
    m = F.linear(m, w7.abs(), b7.abs()) * (h > 0)
    h = F.relu(h)
    w9, b9 = p[f"{STN}.9.weight"].float(), p[f"{STN}.9.bias"].float()
    vec = F.linear(h, w9, b9)
    bound = F.linear(m, w9.abs(), b9.abs())
    return torch.linalg.vector_norm(bound, dim=1) / torch.linalg.vector_norm(vec, dim=1)


def trunk(p, x, precision):
    h = x
    for name in TRUNK:
        h = F.relu(C.conv2d(h, p[name + ".weight"], p[name + ".bias"], precision, stride=2,
                            padding=1))
    h = h.flatten(1).float()
    return _lin(p, "encoder.fc_mu", h), _lin(p, "encoder.fc_logvar", h)


def decode(p, z, precision):
    """fc, ReLU, then four (bilinear 2x upsample, reflection pad 1, conv 3x3)
    stages with ReLU between them, sigmoid."""
    side = int(round((p["decoder.fc.weight"].shape[0] // 256) ** 0.5))
    h = F.relu(_lin(p, "decoder.fc", z)).reshape(z.shape[0], 256, side, side)
    for i, name in enumerate(STAGES):
        h = F.interpolate(h.float(), scale_factor=2, mode="bilinear", align_corners=False)
        h = C.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), p[name + ".weight"],
                     p[name + ".bias"], precision)
        if i < len(STAGES) - 1:
            h = F.relu(h)
    return torch.sigmoid(h.float())


def forward(p, x, eps, precision, x_rot=None):
    """(rotated_recon, recon, theta, mu, logvar, x_canonical, theta_rot);
    theta_rot is None without x_rot."""
    B = x.shape[0]
    conv, io = precision["conv"], precision["io"]
    both = x if x_rot is None else torch.cat([x, x_rot.float()])
    thetas = localize(p, both, conv)
    theta = thetas[:B]
    x_canonical = C.io(C.rotate(C.io(x, io), theta, "reflection"), io)
    mu, logvar = trunk(p, x_canonical, conv)
    z = mu + eps * torch.exp(0.5 * logvar)
    recon = decode(p, z, conv)
    rotated = C.io(C.rotate(C.io(recon, io), -theta, "reflection"), io)
    return rotated, recon, theta, mu, logvar, x_canonical, (None if x_rot is None else thetas[B:])


def paired_loss(p, x, x_rot, angle, eps, precision, loss_cfg: dict):
    """The paired objective, sum-per-sample MSE + beta KL + gamma cycle
    consistency + canonical_weight x MSE(recon, STN-rotated input), and its terms."""
    rr, recon, theta, mu, logvar, canon_in, theta_rot = forward(p, x, eps, precision, x_rot)
    B = x.shape[0]
    rl = torch.sum((rr - x) ** 2) / B
    kl = (-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)).mean()
    cyc = torch.mean(1.0 - torch.cos(theta_rot - theta + angle.reshape(-1, 1)))
    canon = torch.mean((recon - canon_in) ** 2)
    total = rl + loss_cfg["beta"] * kl + loss_cfg["gamma"] * cyc + loss_cfg["canonical_weight"] * canon
    return total, {"recon_loss": rl, "kld_loss": kl, "cycle_loss": cyc, "canonical_loss": canon}


def batch_stats(p, x, eps, precision):
    """The analysis pass's (mu, logvar, per-patch MSE of the canonical
    reconstruction against the input, theta, the angle's condition number)
    of one batch."""
    _, recon, theta, mu, logvar, _, _ = forward(p, x, eps, precision)
    return (mu, logvar, torch.mean((recon - x) ** 2, dim=(1, 2, 3)), theta,
            angle_condition(p, x))
