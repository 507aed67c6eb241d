#!/usr/bin/env python
"""Headline benchmark of the port: sustained rVAE train + encode patches/s on
one GPU (the counterpart of the repository root's bench.py, same protocol).

Run as  python -m livae_tpu_torch.bench

The production configuration (patch 128, padding 32, latent 16, batch 512,
bfloat16 compute, AdamW 1e-3 with weight decay 1e-5, beta = gamma = 10,
canonical weight 0.2, clip 20) on the 1024-pixel synthetic MoS2 frame. Whole
epochs are timed, not bursts: each epoch is 12 fused paired train steps, the
fused paired eval over 2 val batches and one host read of the metrics; 2
epochs are timed after one warm-up epoch. The encode phase is 12 fused encode
steps, timed after a warm-up call. Times are on the host's clock; each timed
region ends in a host read, which waits for the device.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "patches/sec", "vs_baseline": N, "detail": {...}}
`vs_baseline` is against 6.8 patches/s, the PyTorch reference's combined train
and encode rate measured on one CPU core (BASELINE.md); it compares a GPU
with a CPU core and is no speed-up of like for like. The dataset build prints
to stderr, as does the kernel build (before anything is timed). A failure
prints the error line and exits with code 2.

The size flags exist for a quick run on the CPU (`--cpu`, plain PyTorch).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import numpy as np
import torch

from .data.datasets import PairedAdaptiveLatticeDataset
from .data.synthetic import synthetic_mos2_frame
from .device import resolve_device
from .models.rvae import RVAE
from .scripts._common import card_description, prebuild_kernels
from .train.engine import (
    make_fused_encode,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    metrics_to_host,
)
from .train.state import make_optimizer

METRIC = "rvae_train_encode_patches_per_sec_per_chip_sustained"
REFERENCE_BASELINE = 6.8  # patches/sec on one CPU core, BASELINE.md


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--no-amp", action="store_true", help="float32 compute")
    p.add_argument("--frame-size", type=int, default=1024)
    p.add_argument("--patch", type=int, default=128)
    p.add_argument("--padding", type=int, default=32)
    p.add_argument("--latent", type=int, default=16)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--steps-per-epoch", type=int, default=12)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--val-batches", type=int, default=2)
    p.add_argument("--encode-steps", type=int, default=12)
    return p


def run(args) -> dict:
    device = resolve_device("cpu" if args.cpu else None)
    prebuild_kernels(device, file=sys.stderr)  # stdout stays one JSON line
    frame, _ = synthetic_mos2_frame(size=args.frame_size, spacing=40.0, seed=0)
    with contextlib.redirect_stdout(sys.stderr):  # keep stdout = one JSON line
        dataset = PairedAdaptiveLatticeDataset([frame], patch_size=args.patch,
                                               padding=args.padding, device=device)
    n = len(dataset)

    model = RVAE(args.latent, 1, args.patch, None if args.no_amp else "bfloat16",
                 device=device, generator=torch.Generator().manual_seed(1))
    optimizer = make_optimizer(model, 1e-3, optimizer="adamw", weight_decay=1e-5)
    frames_padded, img_idx, coords, margin = dataset.device_site_table
    kw = dict(patch_size=args.patch, padding=args.padding, margin=margin, device=device)
    step = make_fused_rvae_train_step(model, optimizer, cfg=dataset.transform,
                                      canonical_weight=0.2, grad_max_norm=20.0, **kw)
    fused_eval = make_fused_rvae_eval(model, cfg=dataset.transform, canonical_weight=0.2, **kw)
    encode = make_fused_encode(model, **kw)

    def epoch(seed: int) -> dict:
        """One production epoch: fused train, fused eval, host read of the metrics."""
        gen = torch.Generator(device=device).manual_seed(seed)
        idx = torch.randint(0, n, (args.steps_per_epoch, args.batch), generator=gen,
                            device=device)
        tm = step(frames_padded, img_idx, coords, idx, gen, 10.0, 10.0)
        vidx = torch.randint(0, n, (args.val_batches, args.batch), generator=gen, device=device)
        vm = fused_eval(frames_padded, img_idx, coords, vidx, gen, 10.0, 10.0)
        host = metrics_to_host({**{f"val_{k}": v for k, v in vm.items()},
                                "train_loss": tm["loss"]})
        return {k: float(np.mean(v)) for k, v in host.items()}

    m = epoch(0)  # warm-up with the shapes of the timed region
    if not np.isfinite(m["train_loss"]):
        raise RuntimeError(f"warm-up train loss is {m['train_loss']}")

    t0 = time.time()
    for e in range(args.epochs):
        m = epoch(100 + e)
    train_time = time.time() - t0
    train_patches = args.epochs * args.steps_per_epoch * args.batch

    gen = torch.Generator(device=device).manual_seed(500)
    eidx = torch.randint(0, n, (args.encode_steps, args.batch), generator=gen, device=device)
    float(encode(frames_padded, img_idx, coords, eidx)[0].sum())
    t0 = time.time()
    float(encode(frames_padded, img_idx, coords, eidx)[0].sum())
    encode_time = time.time() - t0
    encode_patches = args.encode_steps * args.batch

    combined = (train_patches + encode_patches) / (train_time + encode_time)
    return {
        "metric": METRIC,
        "value": round(combined, 1),
        "unit": "patches/sec",
        "vs_baseline": round(combined / REFERENCE_BASELINE, 1),
        "detail": {
            "train_patches_per_sec_sustained": round(train_patches / train_time, 1),
            "encode_patches_per_sec": round(encode_patches / encode_time, 1),
            "epochs_timed": args.epochs,
            "epoch_includes": "fused train + fused val eval + host metric readback",
            "batch": args.batch,
            "patch": args.patch,
            "baseline": "PyTorch reference on one CPU core, 6.8 patches/sec (BASELINE.md)",
            "device": card_description(device),
        },
    }


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        result = run(args)
    except Exception as e:  # one parseable line whatever happens, and a failing exit code
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "patches/sec",
                          "vs_baseline": 0.0, "error": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
