#!/usr/bin/env python
"""Component-level throughput ablation for the fused rVAE train step (port of
scripts/profile_components.py).

Times each stage of the training pipeline on its own (paired extraction and
its sub-stages, encoder forward, full forward, decoder forward, the inverse
rotation, the paired loss forward, its gradient with and without the
canonical and cycle terms) and the whole fused train step, so optimisation
goes where the time is. Each stage runs `--reps` chained repetitions (a
scalar carry that every repetition adds to, so none is dead) between two
CUDA events, with one synchronisation: the counterpart of the JAX script's
jitted fori_loop. On the CPU the host clock times them.

Run as  python -m livae_tpu_torch.scripts.profile_components
        [--cpu --batch 8 --patch 32]

Prints the card's name and power limit, one `patches/sec` line per stage,
then {"patches_per_sec": ..., "us_per_patch": ...}.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.pipeline import (
    AugmentConfig,
    _crop_rois,
    _minmax_normalize,
    _scale_translate,
    extract_batch_paired,
    pad_frames,
    sample_paired_draws,
)
from ..data.synthetic import synthetic_mos2_frame
from ..device import resolve_device
from ..losses import rvae_loss
from ..models.rvae import RVAE
from ..ops.resample import rotate_image_fast
from ..train.engine import _rvae_paired_loss, make_fused_rvae_train_step
from ..train.state import make_optimizer
from ._common import card_description, prebuild_kernels, sync


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    print(card_description(device), flush=True)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    prebuild_kernels(device)

    P, B, padding = args.patch, args.batch, args.padding
    P2 = P + 2 * padding
    roi = P2 + 16
    margin = roi // 2 + 8
    frame, _ = synthetic_mos2_frame(size=args.frame_size, spacing=40.0, seed=0)
    frames_padded = pad_frames(torch.as_tensor(frame, dtype=torch.float32, device=device)[None],
                               margin)
    H = frame.shape[0]
    rng = np.random.default_rng(0)
    n_sites = 4096
    img_idx = torch.zeros(n_sites, dtype=torch.long, device=device)
    coords = torch.as_tensor(rng.uniform(roi // 2, H - roi // 2, (n_sites, 2)),
                             dtype=torch.float32, device=device)
    cfg = AugmentConfig()
    dtype = "bfloat16" if device.type == "cuda" else None
    model = RVAE(args.latent_dim, 1, P, dtype, device=device,
                 generator=torch.Generator().manual_seed(1))
    params = [p for p in model.parameters()]

    def sites(gen):
        return torch.randint(0, n_sites, (B,), generator=gen, device=device)

    def extract(gen):
        idx = sites(gen)
        return extract_batch_paired(frames_padded, img_idx[idx], coords[idx], gen, P, padding,
                                    cfg=cfg, margin=margin, rot_dtype=dtype)

    def crop(gen):
        idx = sites(gen)
        return _crop_rois(frames_padded, img_idx[idx], coords[idx, 0], coords[idx, 1], roi,
                          margin)

    def resample(gen):
        rois, ry, rx = crop(gen)
        d = sample_paired_draws(B, cfg, gen, device)
        return _scale_translate(rois, ry, rx, P2, d.scale, d.flip_h, d.flip_v, d.jy, d.jx), d

    def paired_loss(x, x_rot, angle, gen):
        return _rvae_paired_loss(model, x, x_rot, angle, 1.0, 1.0, False, 0.2,
                                 generator=gen)[0]

    stages = {}

    def stage(name):
        def deco(body):
            stages[name] = body
            return body

        return deco

    @stage("extract_paired")
    def _(acc, gen):
        x, x_rot, angle = extract(gen)
        return acc + x[0, 0, 0].sum() + x_rot[0, 0, 0].float().sum() + angle[0]

    @stage("x_crop_rois")
    def _(acc, gen):
        rois, ry, rx = crop(gen)
        return acc + rois[0, 0].sum() + ry[0] + rx[0]

    @stage("x_crop_resample")
    def _(acc, gen):
        p_big, _ = resample(gen)
        return acc + p_big[0, 0].sum()

    @stage("x_rot_copy_only")
    def _(acc, gen):
        p_big, d = resample(gen)
        rot_in = p_big[:, None] if dtype is None else p_big[:, None].to(getattr(torch, dtype))
        rot = rotate_image_fast(rot_in, d.angle, "zeros", margin=P2 // 6)[:, 0]
        return acc + rot[0, 0].float().sum()

    @stage("x_normalize_only")
    def _(acc, gen):
        p_big, _ = resample(gen)
        return acc + _minmax_normalize(p_big)[0, 0].sum()

    @stage("encoder_fwd")
    def _(acc, gen):
        x, _, _ = extract(gen)
        mu, logvar, theta = model.encode(x)
        return acc + mu[0].sum() + theta[0, 0]

    @stage("full_fwd")
    def _(acc, gen):
        x, _, _ = extract(gen)
        rotated_recon = model(x, generator=gen)[0]
        return acc + rotated_recon[0, 0, 0].sum()

    @stage("decoder_fwd")
    def _(acc, gen):
        z = torch.randn((B, args.latent_dim), generator=gen, device=device)
        return acc + model.decode(z)[0, 0, 0].sum()

    @stage("inverse_rotate")
    def _(acc, gen):
        x, _, _ = extract(gen)
        theta = torch.rand((B, 1), generator=gen, device=device) * 6.2 - 3.1
        out = rotate_image_fast(x, theta, padding_mode="reflection")
        return acc + out[0, 0, 0].sum()

    @stage("paired_loss_fwd")
    def _(acc, gen):
        return acc + paired_loss(*extract(gen), gen)

    def grad_stage(loss):
        total = loss
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return total.detach() + _global_norm([g for g in grads if g is not None])

    @stage("loss_grad")
    def _(acc, gen):
        with torch.enable_grad():
            return acc + grad_stage(paired_loss(*extract(gen), gen))

    @stage("grad_no_canon")
    def _(acc, gen):
        # ablation: drop the canonical-MSE term
        x, x_rot, angle = extract(gen)
        with torch.enable_grad():
            rr, canonical, theta, mu, logvar, ci, theta_rot = model.train_forward_paired(
                x, x_rot, None, gen)
            total = rvae_loss(rr, x, mu, logvar, theta, theta_rot, angle, beta=1.0,
                              gamma=1.0)[0]
            return acc + grad_stage(total)

    @stage("grad_no_cycle")
    def _(acc, gen):
        # ablation: drop the cycle term and the x_rot localisation pass
        x, _, _ = extract(gen)
        with torch.enable_grad():
            rr, canonical, theta, mu, logvar, ci = model.train_forward(x, None, gen)
            rl = torch.sum((rr - x) ** 2) / x.shape[0]
            kl = torch.mean(-0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=1))
            return acc + grad_stage(rl + kl + 0.2 * torch.mean((canonical - ci) ** 2))

    def timed(fn) -> float:
        """Seconds of fn() between two CUDA events (host clock on the CPU)."""
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    def run_stage(body) -> float:
        def loop(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            acc = torch.zeros((), device=device)
            with torch.no_grad():
                for _ in range(args.reps):
                    acc = body(acc, gen)
            return acc

        float(loop(1))  # warm: cuDNN plans, allocator
        sync(device)
        out = []
        dt = timed(lambda: out.append(loop(2)))
        if not torch.isfinite(out[0]):
            raise RuntimeError("a stage's carry is not finite")
        return B * args.reps / dt

    results = {}
    for name, body in stages.items():
        pps = run_stage(body)
        results[name] = round(pps, 1)
        print(f"{name:>18}: {pps:>10.1f} patches/sec", flush=True)

    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    fused = make_fused_rvae_train_step(model, opt, patch_size=P, padding=padding, cfg=cfg,
                                       margin=margin, canonical_weight=0.2, grad_max_norm=20.0,
                                       device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    idx_batches = torch.randint(0, n_sites, (args.reps, B), generator=gen, device=device)
    float(fused(frames_padded, img_idx, coords, idx_batches, gen, 10.0, 10.0)["loss"])
    sync(device)
    metrics = []
    dt = timed(lambda: metrics.append(fused(frames_padded, img_idx, coords, idx_batches, gen,
                                            10.0, 10.0)))
    if not torch.isfinite(metrics[0]["loss"]):
        raise RuntimeError("the fused train step's loss is not finite")
    results["full_train_step"] = round(B * args.reps / dt, 1)
    print(f"{'full_train_step':>18}: {results['full_train_step']:>10.1f} patches/sec")

    # derived per-stage costs (us per patch) for the breakdown
    us = {k: round(1e6 / v, 2) for k, v in results.items()}
    out = {"patches_per_sec": results, "us_per_patch": us}
    print(json.dumps(out, indent=2))
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train-step component ablation")
    p.add_argument("--patch", type=int, default=128)
    p.add_argument("--padding", type=int, default=32)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--frame-size", type=int, default=1024)
    p.add_argument("--reps", type=int, default=12)
    p.add_argument("--cpu", action="store_true")
    return p


if __name__ == "__main__":
    main()
