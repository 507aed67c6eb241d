#!/usr/bin/env python
"""Train the plain VAE baseline on atom patches, on one GPU or data-parallel
over several (--num-devices, --model-parallel, as in train_rvae).

Run as  python -m livae_tpu_torch.scripts.train_vae --synthetic 2 ...

The flags and defaults are those of scripts/train_vae.py (the JAX entry
point): patch 128, padding 32, batch 512, latent 16, epochs 50, lr 1e-3, Adam
with cosine warm restarts (T_0 = 10 epochs, T_mult = 2), the mean-reduced VAE
loss at beta 1 with optional linear beta annealing, gradient clip 5, best and
_final checkpoints in the reference's torch.save layout.

`--arch spatial` trains spatial-VAE's coordinate-decoder rVAE
(models/spatial_vae.py) through the same epoch loop, fused step, eval,
checkpoints and data-parallel path: `--p-hidden-dim`, `--p-num-layers`,
`--q-hidden-dim`, `--q-num-layers` (upstream's 500, 2, 500, 1),
`--theta-prior` (pi), `--dx-scale` (0.1), `--no-rotate`, `--no-translate`;
`--latent-dim` and `--lr` keep their defaults (upstream's are 2 and 1e-4).
Its large layers are not split over a model axis: --model-parallel stays 1.
"""

from __future__ import annotations

import argparse
import math
import time
from datetime import datetime
from pathlib import Path

import torch

from ..data.datasets import AdaptiveLatticeDataset, default_transform
from ..models.spatial_vae import SpatialVAE
from ..models.vae import VAE
from ..train.engine import (
    MetricLogger,
    evaluate_fused,
    log_reconstructions_tensorboard,
    log_scalar_metrics_tensorboard,
    make_fused_eval,
    make_fused_vae_train_step,
    metrics_to_host,
)
from ..train.state import cosine_warm_restarts, make_optimizer, make_schedule
from ..parallel.mesh import DataMesh
from ..parallel.tensor import full_state_dict
from ..utils.checkpoint import save_reference_checkpoint
from ._common import (
    add_data_flags,
    add_device_flags,
    epoch_index_batches,
    kernel_launches,
    note_ignored_flags,
    place_model,
    prebuild_kernels,
    resolve_images,
    resolve_run_device,
    run_data_parallel,
    split_indices,
    stream_generator,
    sync,
)


def run_training(args) -> dict:
    """Train as the flags say; with --num-devices N > 1 on N spawned ranks,
    returning rank 0's result."""
    device = resolve_run_device(args)
    if args.arch == "spatial" and args.model_parallel != 1:
        raise SystemExit("--arch spatial trains data-parallel only: --model-parallel must be 1")
    return (run_data_parallel(_train, args, device, lambda: _model(args, "cpu"))
            or _train(None, device, args))


def _model(args, device) -> VAE | SpatialVAE:
    common = dict(latent_dim=args.latent_dim, patch_size=args.patch_size,
                  compute_dtype=None if args.no_amp else "bfloat16", device=device,
                  generator=stream_generator(args.seed, "init", 0, "cpu"))
    if args.arch == "spatial":
        return SpatialVAE(hidden_dim=args.p_hidden_dim, num_layers=args.p_num_layers,
                          q_hidden_dim=args.q_hidden_dim, q_num_layers=args.q_num_layers,
                          rotate=not args.no_rotate, translate=not args.no_translate,
                          theta_prior=args.theta_prior, dx_scale=args.dx_scale, **common)
    return VAE(**common)


def _train(mesh: DataMesh | None, device, args) -> dict:
    lead = mesh is None or mesh.world_rank == 0  # the rank that writes
    n_ranks = 1 if mesh is None else mesh.size  # the data ways
    note_ignored_flags(args)
    kernel_build_s = prebuild_kernels(device)
    images = resolve_images(args)

    normalize = not getattr(args, "no_per_patch_norm", False)
    print("Building adaptive-lattice dataset...")
    t_build = time.perf_counter()
    dataset = AdaptiveLatticeDataset(
        images,
        patch_size=args.patch_size,
        padding=args.padding,
        transform=default_transform,
        normalize=normalize,
        device=device,
    )
    dataset_build_s = time.perf_counter() - t_build
    n = len(dataset)
    train_idx, val_idx = split_indices(n, args.val_split, seed=args.seed)
    print(f"Dataset: {n} sites ({len(train_idx)} train / {len(val_idx)} val)")

    model = _model(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{type(model).__name__}: {n_params / 1e6:.2f}M parameters")
    place_model(model, mesh)  # before the optimizer, which must hold the split layers

    steps_per_epoch = max(1, len(train_idx) // args.batch_size)
    lr = cosine_warm_restarts(
        args.lr,
        args.scheduler_t0 * steps_per_epoch,
        args.scheduler_t_mult,
        total_steps=args.epochs * steps_per_epoch,
    )
    optimizer = make_optimizer(model, lr, optimizer="adam")
    scheduler = make_schedule(optimizer, lr)

    eval_kwargs = dict(
        patch_size=args.patch_size, padding=args.padding, margin=dataset._margin,
        normalize=normalize, device=device,
    )
    train_step = make_fused_vae_train_step(
        model, optimizer, cfg=dataset.transform, grad_max_norm=5.0, scheduler=scheduler,
        mesh=mesh, **eval_kwargs,
    )
    # the ragged val tail runs whole on every rank, as the JAX trainer's tail_eval
    tail_eval = make_fused_eval(model, **eval_kwargs)
    fused_eval = tail_eval if mesh is None else make_fused_eval(model, mesh=mesh, **eval_kwargs)
    frames_padded, img_idx_dev, coords_dev, _ = dataset.device_site_table
    train_idx_dev = torch.as_tensor(train_idx, dtype=torch.long, device=device)

    writer = None
    if lead and not args.no_tensorboard:
        from tensorboardX import SummaryWriter

        log_dir = Path(args.log_dir) / datetime.now().strftime("%Y%m%d-%H%M%S")
        writer = SummaryWriter(str(log_dir))
        print(f"TensorBoard logs: {log_dir}")

    ckpt_args = {k: v for k, v in vars(args).items() if not k.startswith("_")}
    best_val = float("inf")
    epochs: list[dict] = []
    t_start = time.time()
    total_patches = 0

    for epoch in range(args.epochs):
        if args.beta_annealing:
            beta = args.beta * min(1.0, (epoch + 1) / max(args.beta_annealing_epochs, 1))
        else:
            beta = args.beta
        train_gen = stream_generator(args.seed, "train", epoch, device)
        val_gen = stream_generator(args.seed, "val", epoch, device)
        launches0 = kernel_launches()

        logger = MetricLogger()
        sync(device)
        t0 = time.time()
        idx_batches = epoch_index_batches(train_idx_dev, args.batch_size, train_gen)
        train_metrics = train_step(
            frames_padded, img_idx_dev, coords_dev, idx_batches, train_gen, beta, 0.0
        )
        train_host = metrics_to_host(train_metrics)  # one transfer
        logger.update(**{f"train_{k}": float(v) for k, v in train_host.items()})
        train_time = time.time() - t0
        total_patches += steps_per_epoch * args.batch_size

        val_bs = min(args.batch_size, len(val_idx))
        val_bs -= val_bs % n_ranks  # the sharded eval's batch
        val_metrics = evaluate_fused(
            fused_eval if val_bs else tail_eval, dataset.device_site_table, val_idx,
            val_bs or len(val_idx), val_gen, logger, beta=beta, tail_eval=tail_eval,
        )
        eval_time = time.time() - t0 - train_time

        metrics = logger.get_averages()
        pps = steps_per_epoch * args.batch_size / train_time
        launches1 = kernel_launches()
        epochs.append({
            "epoch": epoch, "beta": beta, "steps": int(idx_batches.shape[0]),
            "val_batches": -(-len(val_idx) // val_bs), "train_s": train_time,
            "eval_s": eval_time, "metrics": metrics,
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
        })
        print(
            f"Epoch {epoch + 1}/{args.epochs} | "
            f"train {metrics.get('train_loss', float('nan')):.5f} | "
            f"val {metrics.get('val_loss', float('nan')):.5f} | "
            f"psnr {metrics.get('val_psnr', float('nan')):.2f} | "
            f"beta {beta:.3f} | {pps:.0f} patches/s"
        )
        if writer is not None:
            log_scalar_metrics_tensorboard(writer, metrics, epoch)
            writer.add_scalar("train/beta", beta, epoch)
        if not args.no_tensorboard and (epoch + 1) % args.vis_every == 0:
            # every rank runs the forward: a split layer needs its whole model group
            vis_gen = stream_generator(args.seed, "vis", epoch, device)
            x = dataset.batch_at(val_idx[: args.vis_samples])
            with torch.no_grad():
                recon = model(x, generator=vis_gen)[0]
            if writer is not None:
                log_reconstructions_tensorboard(writer, x, recon, epoch)

        # the one-device state: under a model axis every rank gathers, rank 0 writes
        model_state = full_state_dict(model, mesh)
        val_loss = val_metrics.get("val_loss", float("inf"))
        if val_loss < best_val:
            best_val = val_loss
            if lead:
                save_reference_checkpoint(
                    args.checkpoint, model_state, epoch=epoch, best_val=best_val,
                    args=ckpt_args,
                )
                print(f"  -> saved best checkpoint ({args.checkpoint})")

    final_path = str(Path(args.checkpoint).with_suffix("")) + "_final.pt"
    model_state = full_state_dict(model, mesh)
    if lead:
        save_reference_checkpoint(
            final_path, model_state, epoch=args.epochs - 1, best_val=best_val,
            args=ckpt_args,
        )
    wall = time.time() - t_start
    print(f"Done in {wall:.0f}s | best val {best_val:.5f} | "
          f"{total_patches / wall:.0f} patches/sec overall")
    if writer is not None:
        writer.close()
    return {
        "best_val": best_val, "model": model, "optimizer": optimizer, "scheduler": scheduler,
        "epochs": epochs, "dataset_build_s": dataset_build_s, "kernel_build_s": kernel_build_s,
        "final_checkpoint": final_path,
        "sites": (n, len(train_idx), len(val_idx)),
    }


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train standard VAE on atom patches from STEM microscopy (GPU)"
    )
    add_data_flags(parser)
    parser.add_argument("--patch-size", type=int, default=128)
    parser.add_argument("--padding", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--val-split", type=float, default=0.1)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--scheduler-t0", type=int, default=10)
    parser.add_argument("--scheduler-t-mult", type=int, default=2)
    parser.add_argument("--latent-dim", type=int, default=16)
    parser.add_argument("--beta", type=float, default=1.0)
    parser.add_argument("--beta-annealing", action="store_true")
    parser.add_argument("--beta-annealing-epochs", type=int, default=10)
    parser.add_argument(
        "--no-per-patch-norm",
        action="store_true",
        help="Skip the per-patch min-max normalization; persisted in checkpoint "
        "args for the analysis scripts",
    )
    add_device_flags(
        parser,
        "Megatron-style tensor-parallel ways for the large dense layers "
        "(must divide --num-devices)",
    )
    parser.add_argument("--log-dir", type=str, default="runs/vae")
    parser.add_argument("--no-tensorboard", action="store_true")
    parser.add_argument("--vis-every", type=int, default=10)
    parser.add_argument("--vis-samples", type=int, default=8)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/vae_best.pt")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-workers", type=int, default=8, help=argparse.SUPPRESS)
    parser.add_argument("--prefetch-factor", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--compile", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    parser.add_argument(
        "--no-amp",
        action="store_true",
        help="Disable mixed precision (bfloat16 compute); use float32 everywhere",
    )
    spatial = parser.add_argument_group(
        "spatial-VAE (--arch spatial; Bepler et al. 2019, the upstream code's defaults)")
    spatial.add_argument("--arch", choices=("vae", "spatial"), default="vae",
                         help="vae: the convolutional VAE; spatial: spatial-VAE's "
                         "coordinate-decoder rVAE")
    spatial.add_argument("--p-hidden-dim", type=int, default=500,
                         help="generator (coordinate MLP) width")
    spatial.add_argument("--p-num-layers", type=int, default=2, help="generator tanh layers")
    spatial.add_argument("--q-hidden-dim", type=int, default=500,
                         help="inference MLP width")
    spatial.add_argument("--q-num-layers", type=int, default=1,
                         help="inference MLP hidden layers")
    spatial.add_argument("--theta-prior", type=float, default=math.pi,
                         help="std of the rotation's Gaussian prior (radians)")
    spatial.add_argument("--dx-scale", type=float, default=0.1,
                         help="scale of the inferred shift on the [-1, 1] grid")
    spatial.add_argument("--no-rotate", action="store_true",
                         help="infer no rotation")
    spatial.add_argument("--no-translate", action="store_true",
                         help="infer no translation")
    return parser


if __name__ == "__main__":
    run_training(build_argparser().parse_args())
