#!/usr/bin/env python
"""Compare the plain VAE and the rVAE: parameter counts, a forward/backward
smoke test and inference throughput (port of scripts/compare_vae_rvae.py).

Run as  python -m livae_tpu_torch.scripts.compare_vae_rvae [--patch-size 64 ...]

The JAX script's flags and printed fields: both models at float32 on one
random batch (batch 32, patch 64, latent 16 by default), the losses' smoke
test (the VAE loss; the rVAE loss with the rotation-diversity term), and
`--iters` forward passes of each model timed after a warm-up, as ms per batch
and images per second (host clock around work that ends in a synchronisation
of the device). Runs on the CUDA device unless --cpu is given; `main` returns
the figures.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..losses import rvae_loss, vae_loss
from ..models.rvae import RVAE
from ..models.vae import VAE
from ._common import card_description, prebuild_kernels, sync

__all__ = ["count_params", "smoke_test", "bench_model", "build_argparser", "main"]


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def smoke_test(model, x: torch.Tensor, generator: torch.Generator) -> bool:
    """One forward and backward of the model's loss; finite loss and gradient norm."""
    model.zero_grad(set_to_none=True)
    out = model(x, generator=generator)
    if len(out) == 3:
        loss = vae_loss(out[0], x, out[1], out[2])[0]
    else:
        rr, _, th, mu, lv = out
        loss = rvae_loss(rr, x, mu, lv, th, beta=1.0, gamma=1.0, use_diversity=True)[0]
    loss.backward()
    gnorm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in model.parameters()
                           if p.grad is not None))
    val, gnorm = float(loss.detach()), float(gnorm)
    print(f"  forward/backward OK: loss={val:.4f}, grad_norm={gnorm:.2f}")
    return bool(np.isfinite(val) and np.isfinite(gnorm))


@torch.no_grad()
def bench_model(model, x: torch.Tensor, iters: int) -> tuple[float, float]:
    """(ms per batch, images per second) of `iters` forward passes."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    acc = torch.zeros((), device=x.device)
    for _ in range(3):  # warm-up: the first calls pick cuDNN's algorithms
        acc += model(x, generator=gen)[0].sum()
    sync(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        acc += model(x, generator=gen)[0].sum()
    float(acc)  # the host read waits for the device
    dt = (time.perf_counter() - t0) / iters
    return dt * 1000, x.shape[0] / dt


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Compare VAE and rVAE (dry run + bench)")
    parser.add_argument("--patch-size", type=int, default=64)
    parser.add_argument("--latent-dim", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    return parser


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device)
    P, L, B = args.patch_size, args.latent_dim, args.batch_size
    x = torch.from_numpy(np.random.default_rng(0).random((B, 1, P, P), dtype=np.float32)).to(device)

    print("=" * 60)
    print("Model construction + parameter counts")
    print("=" * 60)
    vae = VAE(L, 1, P, device=device, generator=torch.Generator().manual_seed(0))
    rvae = RVAE(L, 1, P, device=device, generator=torch.Generator().manual_seed(0))
    nv, nr = count_params(vae), count_params(rvae)
    print(f"  VAE : {nv / 1e6:.2f}M params")
    print(f"  rVAE: {nr / 1e6:.2f}M params (+{(nr - nv) / 1e3:.0f}K for the STN)")

    print("=" * 60)
    print("Forward/backward smoke test")
    print("=" * 60)
    gen = torch.Generator(device=device).manual_seed(0)
    print("VAE:")
    ok_v = smoke_test(vae, x, gen)
    print("rVAE:")
    ok_r = smoke_test(rvae, x, gen)

    print("=" * 60)
    print("Component comparison")
    print("=" * 60)
    print("  encoder trunk: identical 4x stride-2 conv (1->32->64->128->256)")
    print("  rVAE adds: RotationSTN localization net + 2 rotation resamples")
    print("  decoder: VAE ConvTranspose mirror vs rVAE upsample+conv (no checkerboard)")

    print("=" * 60)
    print(f"Throughput microbenchmark (batch {B} x {args.iters} iters, patch {P})")
    print("=" * 60)
    ms_v, ips_v = bench_model(vae, x, args.iters)
    print(f"  VAE : {ms_v:.2f} ms/batch, {ips_v:.0f} imgs/sec")
    ms_r, ips_r = bench_model(rvae, x, args.iters)
    print(f"  rVAE: {ms_r:.2f} ms/batch, {ips_r:.0f} imgs/sec")
    slowdown = (ms_r - ms_v) / ms_v * 100
    print(f"  rVAE inference is {slowdown:+.0f}% vs VAE on this device ({card_description(device)})")
    print("=" * 60)
    ok = ok_v and ok_r
    print("PASS" if ok else "FAIL")
    return {"vae_params": nv, "rvae_params": nr, "ok": ok, "vae_ms": ms_v, "vae_imgs_per_s": ips_v,
            "rvae_ms": ms_r, "rvae_imgs_per_s": ips_r}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
