#!/usr/bin/env python
"""Train the rotationally-invariant VAE (rVAE) on atom patches, on one GPU or
data-parallel over several (--num-devices).

Run as  python -m livae_tpu_torch.scripts.train_rvae --synthetic 2 ...

The flags and defaults are those of scripts/train_rvae.py (the JAX entry
point): patch 128, padding 32, batch 512, latent 16, epochs 50, lr 1e-3,
beta 10, gamma 10, AdamW weight decay 1e-5, cosine annealing, beta annealing
(warm-up 5, ramp 15), --stn-checkpoint / --freeze-stn / --stn-lr, best and
_final checkpoints in the reference's torch.save layout, --resume.

On the card the convolutions run in bfloat16 (--no-amp: float32). --cpu runs
the plain PyTorch versions on the CPU, and is the only way onto it.
--num-devices N (or "auto") trains on N ranks, one process per device (NCCL on
the cards, gloo with --cpu), the global batch shared out among them step for
step as on one device (parallel/mesh.py); with --model-parallel M the ranks
form N / M data ways x M model ways and the large dense layers are split
Megatron-style over each model group (parallel/tensor.py). Rank 0 alone
writes checkpoints (the one-device model's, gathered), logs and the results.
--num-workers, --prefetch-factor and --compile are accepted and ignored.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from pathlib import Path

import torch

from ..data.datasets import PairedAdaptiveLatticeDataset, default_transform
from ..models.rvae import RVAE
from ..train.engine import (
    MetricLogger,
    evaluate_fused,
    log_reconstructions_tensorboard,
    log_scalar_metrics_tensorboard,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    metrics_to_host,
)
from ..train.state import beta_at_epoch, cosine_annealing, make_optimizer, make_schedule
from ..parallel.mesh import DataMesh
from ..parallel.tensor import (
    full_optimizer_state,
    full_state_dict,
    load_full_optimizer_state,
    load_full_state_dict,
)
from ..utils.checkpoint import clean_state_dict, load_checkpoint, save_reference_checkpoint
from ..utils.resume import latest_step, restore_train_state, save_train_state
from ._common import (
    add_data_flags,
    add_device_flags,
    epoch_index_batches,
    kernel_launches,
    note_ignored_flags,
    place_model,
    prebuild_kernels,
    profile_epoch,
    resolve_images,
    resolve_run_device,
    run_data_parallel,
    split_indices,
    state_digest,
    stream_generator,
    sync,
)


def run_training(args) -> dict:
    """Train as the flags say; with --num-devices N > 1 on N spawned ranks,
    returning rank 0's result."""
    device = resolve_run_device(args)
    return (run_data_parallel(_train, args, device, lambda: _model(args, "cpu"))
            or _train(None, device, args))


def _model(args, device) -> RVAE:
    return RVAE(
        latent_dim=args.latent_dim,
        patch_size=args.patch_size,
        compute_dtype=None if args.no_amp else "bfloat16",
        fast_resample=not args.exact_resample,
        device=device,
        generator=stream_generator(args.seed, "init", 0, "cpu"),
    )


def _train(mesh: DataMesh | None, device, args) -> dict:
    lead = mesh is None or mesh.world_rank == 0  # the rank that writes
    n_ranks = 1 if mesh is None else mesh.size  # the data ways
    note_ignored_flags(args)
    kernel_build_s = prebuild_kernels(device)
    images = resolve_images(args)

    normalize = not getattr(args, "no_per_patch_norm", False)
    print("Building paired adaptive-lattice dataset...")
    t_build = time.perf_counter()
    dataset = PairedAdaptiveLatticeDataset(
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
    print(f"RVAE: {n_params / 1e6:.2f}M parameters")

    if args.stn_checkpoint:
        stn_state = clean_state_dict(load_checkpoint(args.stn_checkpoint)["rotation_stn"])
        model.encoder.rotation_stn.load_state_dict(stn_state, strict=True)
        print(f"Loaded pretrained STN from {args.stn_checkpoint}")
    place_model(model, mesh)  # before the optimizer, which must hold the split layers

    steps_per_epoch = max(1, len(train_idx) // args.batch_size)
    lr = cosine_annealing(args.lr, args.epochs * steps_per_epoch)
    stn_lr = None
    if args.stn_lr is not None:
        stn_lr = cosine_annealing(args.stn_lr, args.epochs * steps_per_epoch)
    optimizer = make_optimizer(
        model, lr, optimizer="adamw", weight_decay=args.weight_decay,
        stn_learning_rate=stn_lr, freeze_stn=args.freeze_stn,
    )
    scheduler = make_schedule(optimizer, lr, stn_lr)

    step_kwargs = dict(
        patch_size=args.patch_size,
        padding=args.padding,
        cfg=dataset.transform,
        margin=dataset._margin,
        use_diversity=args.use_diversity_loss,
        canonical_weight=args.canonical_weight,
        normalize=normalize,
        device=device,
    )
    train_step = make_fused_rvae_train_step(
        model, optimizer, scheduler=scheduler,
        grad_max_norm=args.grad_max_norm if args.grad_max_norm is not None else 20.0,
        mesh=mesh, **step_kwargs,
    )
    # the ragged val tail runs whole on every rank, as the JAX trainer's tail_eval
    tail_eval = make_fused_rvae_eval(model, **step_kwargs)
    fused_eval = tail_eval if mesh is None else make_fused_rvae_eval(
        model, mesh=mesh, **step_kwargs)
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
    history = MetricLogger()
    epochs: list[dict] = []
    total_patches = 0
    show_digest = bool(os.environ.get("LIVAE_PARAM_HASH"))
    resumed_digest = None
    t_start = time.time()

    start_epoch = 0
    resume_dir = args.resume_dir or str(Path(args.checkpoint).parent / "resume_rvae")
    if args.resume:
        if latest_step(resume_dir) is not None:
            # read on the host: load_state_dict moves each tensor to its parameter's
            # device and leaves the optimizer's step counts where torch keeps them
            state, meta = restore_train_state(resume_dir)
            if int(meta.get("seed", args.seed)) != args.seed:
                raise SystemExit(
                    f"--seed {args.seed} differs from the checkpoint's seed "
                    f"{meta['seed']}; pass the original seed to resume "
                    "deterministically"
                )
            load_full_state_dict(model, state["model"], mesh)
            load_full_optimizer_state(optimizer, state["optimizer"], mesh)
            scheduler.load_state_dict(state["scheduler"])
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_val = float(meta.get("best_val", float("inf")))
            print(f"Resumed from {resume_dir} at epoch {start_epoch}")
            if show_digest:
                resumed_digest = state_digest(model, optimizer, scheduler, mesh)
                print(f"PARAMHASH resumed {resumed_digest}", flush=True)
        else:
            print(f"--resume: no checkpoint in {resume_dir}; starting fresh")

    for epoch in range(start_epoch, args.epochs):
        beta = beta_at_epoch(
            epoch,
            args.beta,
            anneal=args.beta_annealing,
            warmup_epochs=args.beta_warmup_epochs,
            ramp_epochs=args.beta_annealing_epochs,
        )
        train_gen = stream_generator(args.seed, "train", epoch, device)
        val_gen = stream_generator(args.seed, "val", epoch, device)
        launches0 = kernel_launches()

        with profile_epoch(lead and args.profile and epoch == start_epoch + 1, args.log_dir,
                           device):
            epoch_logger = MetricLogger()
            sync(device)
            t0 = time.time()
            idx_batches = epoch_index_batches(train_idx_dev, args.batch_size, train_gen)
            lrs = scheduler.get_last_lr()  # at the epoch's first step
            train_metrics = train_step(
                frames_padded, img_idx_dev, coords_dev, idx_batches, train_gen, beta, args.gamma
            )
            train_host = metrics_to_host(train_metrics)  # one transfer
            epoch_logger.update(**{f"train_{k}": float(v) for k, v in train_host.items()})
            train_time = time.time() - t0
            total_patches += steps_per_epoch * args.batch_size

            val_bs = min(args.batch_size, len(val_idx))
            val_bs -= val_bs % n_ranks  # the sharded eval's batch
            val_metrics = evaluate_fused(
                fused_eval if val_bs else tail_eval, dataset.device_site_table, val_idx,
                val_bs or len(val_idx), val_gen, epoch_logger, beta=beta, gamma=args.gamma,
                tail_eval=tail_eval,
            )
            eval_time = time.time() - t0 - train_time

        digest = None
        if show_digest:
            digest = state_digest(model, optimizer, scheduler, mesh)
            print(f"PARAMHASH epoch {epoch} {digest}", flush=True)

        metrics = epoch_logger.get_averages()
        history.update(**metrics)
        pps = steps_per_epoch * args.batch_size / train_time
        launches1 = kernel_launches()
        epochs.append({
            "epoch": epoch, "beta": beta, "steps": int(idx_batches.shape[0]),
            "val_batches": -(-len(val_idx) // val_bs), "train_s": train_time,
            "eval_s": eval_time, "lr_first_step": lrs,
            "lr_last_step": [rate(scheduler.last_epoch - 1) for rate in scheduler.lr_lambdas],
            "metrics": metrics, "digest": digest,
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
        })
        print(
            f"Epoch {epoch + 1}/{args.epochs} | "
            f"train {metrics.get('train_loss', float('nan')):.4f} | "
            f"val {metrics.get('val_loss', float('nan')):.4f} | "
            f"recon {metrics.get('val_recon_loss', float('nan')):.4f} | "
            f"kld {metrics.get('val_kld_loss', float('nan')):.4f} | "
            f"cycle {metrics.get('val_cycle_loss', float('nan')):.4f} | "
            f"rot_std {metrics.get('train_rotation_std', float('nan')):.3f} | "
            f"beta {beta:.3f} | {pps:.0f} patches/s"
        )

        if writer is not None:
            log_scalar_metrics_tensorboard(writer, metrics, epoch)
            writer.add_scalar("train/beta", beta, epoch)
            writer.add_scalar("train/patches_per_sec", pps, epoch)
        if not args.no_tensorboard and (epoch + 1) % args.vis_every == 0:
            # every rank runs the forward: a split layer needs its whole model group
            vis_gen = stream_generator(args.seed, "vis", epoch, device)
            x, _, _ = dataset.batch_at(val_idx[: args.vis_samples], vis_gen)
            with torch.no_grad():
                rotated_recon, canonical, _, _, _, canonical_input = model.train_forward(
                    x, generator=vis_gen
                )
            if writer is not None:
                log_reconstructions_tensorboard(
                    writer, x, rotated_recon, epoch,
                    canonical=canonical, canonical_input=canonical_input,
                )

        # the one-device state: under a model axis every rank gathers, rank 0 writes
        model_state = full_state_dict(model, mesh)
        if args.resume or args.checkpoint_every:
            if args.checkpoint_every == 0 or (epoch + 1) % max(args.checkpoint_every, 1) == 0:
                optimizer_state = full_optimizer_state(optimizer, mesh)
                if lead:
                    save_train_state(
                        resume_dir, epoch,
                        {"model": model_state, "optimizer": optimizer_state,
                         "scheduler": scheduler.state_dict()},
                        {"epoch": epoch, "best_val": best_val, "seed": args.seed},
                    )

        val_loss = val_metrics.get("val_loss", float("inf"))
        if val_loss < best_val:
            best_val = val_loss
            if lead:
                save_reference_checkpoint(
                    args.checkpoint, model_state, epoch=epoch, best_val=best_val,
                    args=ckpt_args,
                )
                print(f"  -> saved best checkpoint ({args.checkpoint})")

        if args.stop_after_epochs and (epoch + 1 - start_epoch) >= args.stop_after_epochs:
            print(f"Stopping after {args.stop_after_epochs} epochs this run "
                  f"(epoch {epoch + 1}/{args.epochs}); resume with --resume")
            break

    # failsafe final checkpoint
    final_path = str(Path(args.checkpoint).with_suffix("")) + "_final.pt"
    model_state = full_state_dict(model, mesh)
    if lead:
        save_reference_checkpoint(
            final_path, model_state, epoch=args.epochs - 1, best_val=best_val,
            args=ckpt_args,
        )
    wall = time.time() - t_start
    print(
        f"Done in {wall:.0f}s | best val {best_val:.4f} | "
        f"{total_patches / wall:.0f} train patches/sec overall"
    )
    if writer is not None:
        writer.close()
    return {
        "best_val": best_val, "history": history.get_averages(), "model": model,
        "optimizer": optimizer, "scheduler": scheduler, "epochs": epochs,
        "start_epoch": start_epoch, "resumed_digest": resumed_digest,
        "dataset_build_s": dataset_build_s, "kernel_build_s": kernel_build_s,
        "final_checkpoint": final_path,
        "sites": (n, len(train_idx), len(val_idx)),
    }


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train rotationally-invariant VAE on STEM atom patches (GPU)"
    )
    add_data_flags(parser)
    parser.add_argument("--patch-size", type=int, default=128)
    parser.add_argument("--padding", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--val-split", type=float, default=0.1)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--latent-dim", type=int, default=16)
    parser.add_argument("--beta", type=float, default=10.0)
    parser.add_argument("--gamma", type=float, default=10.0)
    parser.add_argument("--use-diversity-loss", action="store_true")
    parser.add_argument("--beta-annealing", action="store_true")
    parser.add_argument("--beta-warmup-epochs", type=int, default=5)
    parser.add_argument("--beta-annealing-epochs", type=int, default=15)
    parser.add_argument("--canonical-weight", type=float, default=0.2)
    parser.add_argument(
        "--no-per-patch-norm",
        action="store_true",
        help="Skip the per-patch min-max normalization. Recommended for vacancy "
        "clustering; persisted in checkpoint args so the analysis scripts "
        "encode with matching semantics",
    )
    parser.add_argument("--stn-checkpoint", type=str, default=None)
    parser.add_argument("--freeze-stn", action="store_true")
    parser.add_argument("--stn-lr", type=float, default=None)
    parser.add_argument("--grad-max-norm", type=float, default=None)
    add_device_flags(
        parser,
        "Megatron-style tensor-parallel ways for the large dense layers "
        "(must divide --num-devices)",
    )
    parser.add_argument("--log-dir", type=str, default="runs/rvae")
    parser.add_argument("--no-tensorboard", action="store_true")
    parser.add_argument("--vis-every", type=int, default=10)
    parser.add_argument("--vis-samples", type=int, default=8)
    parser.add_argument(
        "--checkpoint", type=str, default="checkpoints/rvae_best.pt"
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--resume",
        action="store_true",
        help="Resume from the full-state checkpoint (weights, optimizer, schedule)",
    )
    parser.add_argument("--resume-dir", type=str, default=None)
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=0,
        help="Write a resume checkpoint every N epochs (0: only with --resume)",
    )
    parser.add_argument(
        "--stop-after-epochs",
        type=int,
        default=None,
        help="Stop after N epochs this run (simulated interruption; schedules "
        "still span --epochs, so a later --resume run continues identically)",
    )
    parser.add_argument(
        "--profile",
        action="store_true",
        help="Capture a torch.profiler trace of the second epoch to <log-dir>/profile",
    )
    parser.add_argument(
        "--exact-resample",
        action="store_true",
        help="Use the exact bilinear resampler instead of the fast 3-shear path",
    )
    # accepted for CLI compatibility and ignored: batches are extracted on the device
    parser.add_argument("--num-workers", type=int, default=8, help=argparse.SUPPRESS)
    parser.add_argument("--prefetch-factor", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--compile", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    parser.add_argument(
        "--no-amp",
        action="store_true",
        help="Disable mixed precision (bfloat16 compute); use float32 everywhere",
    )
    return parser


if __name__ == "__main__":
    run_training(build_argparser().parse_args())
