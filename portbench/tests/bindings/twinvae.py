"""A binding that no entry of BENCHMARK.json names, for the tests: the port's
VAE bound a second time, under a name that no shared file holds, with an
analysis pass (a model with no angle) and a kernel-map entry of its own. The
tests put this directory on the models package's path, where a new
models/<model>.py would be found."""

from __future__ import annotations

import torch

from portbench.loops.common import augment_draws
from portbench.models import vae
from portbench.reference import rvae as ref_rvae, vae as ref_vae

PAIRED = False
LATENT_BIASES = {"mu": "encoder.fc_mu.bias", "logvar": "encoder.fc_logvar.bias"}
KERNELS = {"twin_probe": [r"\btwin_probe_kernel\b"]}
PROBE_BYTES = 4096  # a train step's bytes of the probe operation, per patch

draws = augment_draws
train_model = vae.train_model
train_step = vae.train_step
reference_loss = ref_vae.loss
forward_flops = vae.forward_flops
train_flops = vae.train_flops


def analysis_model(cfg: dict, device):
    from livae_tpu_torch.models.vae import VAE

    model = VAE(latent_dim=cfg["latent_dim"], patch_size=cfg["patch_size"], device=device,
                generator=torch.Generator().manual_seed(0))
    return model, False


def reference_stats(p, x, eps, precision) -> dict:
    mu, logvar = ref_rvae.trunk(p, x, precision["conv"])
    recon = ref_vae.decode(p, mu + eps * torch.exp(0.5 * logvar), precision["conv"])
    return {"mu": mu, "logvar": logvar, "rec_err": torch.mean((recon - x) ** 2, dim=(1, 2, 3))}


def kernel_ops(phase: str, cfg: dict, padding: int, B: int, elem: int) -> list[tuple[str, int]]:
    return [("twin_probe", PROBE_BYTES * B)] if phase == "train" else []
