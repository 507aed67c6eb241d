#!/usr/bin/env python
"""Hyperparameter search for rVAE training on one GPU (port of
scripts/train_rvae_raytune.py).

Run as  python -m livae_tpu_torch.scripts.train_rvae_raytune --synthetic 2 ...

The flags, defaults, search space and schedulers of the JAX script: lr,
latent_dim, beta, weight_decay and batch_size as loguniform / choice (with
--search-norm and --search-gamma also normalize and gamma), ASHA (grace period
clamped to epochs / 2) or PBT (lr and beta mutated), the native TPE for
--search-alg hyperopt or tpe, per-epoch report and checkpoint, results.json
under <--ray-results-dir>/<--experiment-name>/ and the best trial's config in
--save-best-config, which train_rvae_with_best retrains from.

Each trial trains its own RVAE (bfloat16 convolutions on the card, float32
with --cpu) with AdamW under the mean-reduced VAE loss, through the fused
whole-epoch VAE step and the fused eval: the reference's trial function. The
learning rate follows a per-epoch cosine and is written, with the weight
decay, into the optimizer's groups at each epoch's start (optax's
inject_hyperparams). On a PBT exploit a trial takes the donor's lr and beta
and, where the architecture matches, the donor checkpoint's weights with a
fresh optimizer state. Trials share the dataset of their (patch, padding,
normalize), never a model: a model and its optimizer are a trial's state.

Executors: thread (the default when --max-concurrent > 1; trials share the
card), sequential, or process (--executor process: one spawned process per
trial slot, each slot pinned by CUDA_VISIBLE_DEVICES, see
`default_trial_env`), or --stacked K: K trials of one architecture trained
at once in one vmapped program (`make_stacked_trainable`, on
livae_tpu_torch.sweep.stacked), with every trial's full epoch budget (no
scheduler) and each lane the same experiment as the sequential trial of its
id. The kernels are built once, before the first trial; threads and children
only load them. Runs on the CUDA device unless --cpu is given.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import threading
import time
from pathlib import Path

import torch

from ..data.datasets import AdaptiveLatticeDataset, default_transform
from ..device import resolve_device
from ..models.rvae import RVAE
from ..ops import _build
from ..sweep import (
    ASHAScheduler,
    PBTScheduler,
    choice,
    get_best_result,
    loguniform,
    make_stacked_fns,
    run_search,
    run_search_stacked,
    set_stacked_hyperparams,
)
from ..sweep.stacked import StackedState
from ..train.engine import evaluate_fused, make_fused_eval, make_fused_vae_train_step, metrics_to_host
from ..train.state import make_optimizer
from ..utils.checkpoint import load_reference_checkpoint, save_reference_checkpoint
from ._common import (
    add_data_flags,
    epoch_index_batches,
    kernel_launches,
    prebuild_kernels,
    resolve_images,
    split_indices,
    stream_generator,
    sync,
)

__all__ = [
    "make_trainable",
    "make_stacked_trainable",
    "process_trainable",
    "default_trial_env",
    "run_hyperparameter_search",
    "build_argparser",
]


def _build_compiled(dataset, patch_size, padding, latent_dim, grad_max_norm, normalize,
                    device, trial_seed):
    """One trial's model, optimizer, fused train step and fused eval (nothing
    is compiled: the name is the JAX script's). The weights come from a
    generator of (trial_seed, "init"); lr and weight decay are set per epoch."""
    model = RVAE(
        latent_dim=latent_dim, patch_size=patch_size,
        compute_dtype="bfloat16" if device.type == "cuda" else None,
        device=device, generator=stream_generator(trial_seed, "init", 0, "cpu"),
    )
    optimizer = make_optimizer(model, 1e-3, optimizer="adamw", weight_decay=1e-5)
    step = make_fused_vae_train_step(
        model, optimizer, patch_size=patch_size, padding=padding, cfg=dataset.transform,
        margin=dataset._margin, grad_max_norm=grad_max_norm, normalize=normalize, device=device,
    )
    fused_eval = make_fused_eval(model, patch_size=patch_size, padding=padding,
                                 margin=dataset._margin, normalize=normalize, device=device)
    return model, optimizer, step, fused_eval


def _set_hyperparams(optimizer, lr, weight_decay):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
        group["weight_decay"] = float(weight_decay)


def _trial_body(config, report, dataset, compiled, ckpt_path, trial_seed, extra_metrics=None):
    """One trial's training loop (the thread and process paths share it).

    Each report carries, besides the JAX script's metrics, the epoch's train
    steps, val batches, train seconds and train patches/s, and the process's
    kernel launch counts and peak memory so far (`kernel_launches`; under the
    thread executor they count every trial of the process).
    """
    model, optimizer, step, fused_eval = compiled
    device = dataset.device
    train_idx, val_idx = split_indices(len(dataset), config["val_split"], seed=0)
    if len(train_idx) == 0:
        raise ValueError(
            f"empty train split ({len(dataset)} sites total); use larger frames or a "
            "smaller --val-split"
        )
    batch_size = min(int(config["batch_size"]), len(train_idx))
    patch_size = int(config["patch_size"])
    latent_dim = int(config["latent_dim"])
    epochs = int(config["epochs"])
    frames_padded, img_idx_dev, coords_dev, _ = dataset.device_site_table
    train_idx_dev = torch.as_tensor(train_idx, dtype=torch.long, device=device)
    val_bs = min(batch_size, len(val_idx))

    for epoch in range(epochs):
        beta = config["beta"]
        if config.get("beta_annealing"):
            beta *= min(1.0, (epoch + 1) / max(config["beta_annealing_epochs"], 1))
        lr_e = 0.5 * config["lr"] * (1.0 + math.cos(math.pi * epoch / max(epochs, 1)))
        _set_hyperparams(optimizer, lr_e, config["weight_decay"])
        train_gen = stream_generator(trial_seed, "train", epoch, device)
        val_gen = stream_generator(trial_seed, "val", epoch, device)
        gamma = float(config.get("gamma") or 0.0)

        sync(device)
        t0 = time.perf_counter()
        idx_batches = epoch_index_batches(train_idx_dev, batch_size, train_gen)
        tm = metrics_to_host(step(frames_padded, img_idx_dev, coords_dev, idx_batches,
                                  train_gen, beta, gamma))  # one transfer ends the epoch
        train_s = time.perf_counter() - t0
        vm = evaluate_fused(fused_eval, dataset.device_site_table, val_idx, val_bs, val_gen,
                            beta=beta, gamma=gamma)
        val_loss = vm.get("val_loss", float("inf"))

        save_reference_checkpoint(
            ckpt_path, model.state_dict(), epoch=epoch, best_val=val_loss,
            args={k: v for k, v in config.items() if not isinstance(v, (list, dict))},
        )
        steps = int(idx_batches.shape[0])
        out = report(
            epoch=epoch + 1,
            loss=val_loss,
            val_loss=val_loss,
            train_loss=float(tm["loss"]),
            val_psnr=vm.get("val_psnr", 0.0),
            checkpoint=ckpt_path,
            steps=steps,
            val_batches=-(-len(val_idx) // val_bs),
            train_s=train_s,
            train_patches_per_s=steps * batch_size / train_s,
            max_memory_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else 0.0),
            **kernel_launches(),
            **(extra_metrics or {}),
        )
        if isinstance(out, dict):
            # PBT exploit: the donor's mutated lr and beta for the remaining
            # epochs and, where the architecture matches, the donor checkpoint's
            # weights with a fresh optimizer state (Ray PBT's restore).
            new_cfg = out["config"]
            config.update({k: v for k, v in new_cfg.items() if k in ("lr", "beta")})
            donor_ckpt = out.get("checkpoint")
            same_arch = (int(new_cfg.get("latent_dim", latent_dim)) == latent_dim
                         and int(new_cfg.get("patch_size", patch_size)) == patch_size)
            loaded = bool(donor_ckpt and same_arch and Path(str(donor_ckpt)).exists())
            if loaded:
                state, _ = load_reference_checkpoint(str(donor_ckpt))
                model.load_state_dict(state, strict=True)
                optimizer.state.clear()
            print(f"trial {trial_seed} epoch {epoch + 1}: PBT exploit, lr {config['lr']:.3g}, "
                  f"beta {config['beta']:.3g}; "
                  + (f"loaded donor checkpoint {donor_ckpt}" if loaded else
                     f"kept its weights (donor latent_dim {new_cfg.get('latent_dim')})"),
                  flush=True)


def make_trainable(args, images, device):
    """The per-trial training function of the thread and sequential executors.

    Each (patch_size, padding, normalize) dataset is built once, under a lock,
    and shared; every trial builds its own model and optimizer.
    """
    dataset_cache: dict[tuple, AdaptiveLatticeDataset] = {}
    cache_lock = threading.Lock()

    def get_dataset(patch_size, padding, normalize):
        key = (patch_size, padding, normalize)
        with cache_lock:
            if key not in dataset_cache:
                dataset_cache[key] = AdaptiveLatticeDataset(
                    images, patch_size=patch_size, padding=padding,
                    transform=default_transform, normalize=normalize, device=device,
                )
            return dataset_cache[key]

    ckpt_dir = Path(args.ray_results_dir) / args.experiment_name / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    trial_counter = [0]

    def train_rvae_tune(config, report):
        with cache_lock:
            trial_id = trial_counter[0]
            trial_counter[0] += 1
        normalize = bool(config.get("normalize", True))
        dataset = get_dataset(config["patch_size"], config["padding"], normalize)
        compiled = _build_compiled(
            dataset, int(config["patch_size"]), int(config["padding"]),
            int(config["latent_dim"]), float(config.get("grad_max_norm") or 20.0), normalize,
            device, trial_id,
        )
        ckpt_path = str(ckpt_dir / f"trial_{trial_id}.pt")
        _trial_body(config, report, dataset, compiled, ckpt_path, trial_seed=trial_id)

    return train_rvae_tune


def _evaluate_stacked(stacked_eval, state, site_table, val_idx, batch_size, generators, beta,
                      gamma) -> list[dict[str, float]]:
    """The stacked counterpart of `evaluate_fused`: every lane's eval over all
    val sites, the full batches and then the ragged tail as one smaller batch,
    batches weighing equally; lane k's noise from generators[k]. Returns each
    lane's {"val_<name>": mean}."""
    frames_padded, img_idx, coords, _ = site_table
    val_idx = torch.as_tensor(val_idx, dtype=torch.long, device=frames_padded.device)
    K, n = len(generators), len(val_idx)
    bs = min(batch_size, n)
    n_full = n // bs
    parts = []
    if n_full > 0:
        parts.append(val_idx[: n_full * bs].reshape(n_full, bs))
    if n_full * bs < n:
        parts.append(val_idx[n_full * bs :].reshape(1, -1))
    rows = [metrics_to_host(stacked_eval(state.params, frames_padded, img_idx, coords,
                                         part.expand(K, *part.shape), generators, beta, gamma))
            for part in parts]  # {name: [K, S]} per part, one transfer each
    count = sum(len(next(iter(r.values()))[0]) for r in rows)
    return [{"val_" + k: sum(float(r[k][lane].sum()) for r in rows) / count for k in rows[0]}
            for lane in range(K)]


def make_stacked_trainable(args, images, device):
    """The trainable of `run_search_stacked`: trains a group of K configs of one
    architecture as K lanes of one vmapped program.

    Per epoch it follows `_trial_body` lane by lane: the cosine lr and the beta
    annealing, generators of (trial id, "train" | "val", epoch), one
    reference-format checkpoint `trial_<id>.pt` per lane and one report per
    lane. Lane i starts from the weights of the sequential trial with its id
    (a generator of (id, "init")), so a stacked sweep is the same experiment as
    a sequential one, K trials at a time. Each report carries `_trial_body`'s
    extra fields; steps, train seconds and train patches/s are the whole
    stack's, as are the launch counts and the peak memory.
    """
    dataset_cache: dict[tuple, AdaptiveLatticeDataset] = {}
    ckpt_dir = Path(args.ray_results_dir) / args.experiment_name / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    trial_counter = [0]

    def get_dataset(patch_size, padding, normalize):
        key = (patch_size, padding, normalize)
        if key not in dataset_cache:
            dataset_cache[key] = AdaptiveLatticeDataset(
                images, patch_size=patch_size, padding=padding, transform=default_transform,
                normalize=normalize, device=device,
            )
        return dataset_cache[key]

    def stacked_trainable(configs, report):
        cfg0, K = configs[0], len(configs)
        trial_ids = list(range(trial_counter[0], trial_counter[0] + K))
        trial_counter[0] += K
        normalize = bool(cfg0.get("normalize", True))
        patch_size, padding = int(cfg0["patch_size"]), int(cfg0["padding"])
        latent_dim, epochs = int(cfg0["latent_dim"]), int(cfg0["epochs"])
        dataset = get_dataset(patch_size, padding, normalize)
        models = [RVAE(latent_dim=latent_dim, patch_size=patch_size,
                       compute_dtype="bfloat16" if device.type == "cuda" else None,
                       device=device, generator=stream_generator(tid, "init", 0, "cpu"))
                  for tid in trial_ids]
        stacked_step, stacked_eval = make_stacked_fns(
            models[0], patch_size=patch_size, padding=padding, cfg=dataset.transform,
            margin=dataset._margin, grad_max_norm=float(cfg0.get("grad_max_norm") or 20.0),
            normalize=normalize, device=device,
        )
        state = StackedState.create(models)
        del models

        train_idx, val_idx = split_indices(len(dataset), cfg0["val_split"], seed=0)
        if len(train_idx) == 0:
            raise ValueError(
                f"empty train split ({len(dataset)} sites total); use larger frames or a "
                "smaller --val-split"
            )
        batch_size = min(int(cfg0["batch_size"]), len(train_idx))
        train_idx_dev = torch.as_tensor(train_idx, dtype=torch.long, device=device)
        val_bs = min(batch_size, len(val_idx))
        gammas = [float(c.get("gamma") or 0.0) for c in configs]

        for epoch in range(epochs):
            anneal = 1.0
            if cfg0.get("beta_annealing"):
                anneal = min(1.0, (epoch + 1) / max(cfg0["beta_annealing_epochs"], 1))
            betas = [c["beta"] * anneal for c in configs]
            set_stacked_hyperparams(
                state,
                [0.5 * c["lr"] * (1.0 + math.cos(math.pi * epoch / max(epochs, 1)))
                 for c in configs],
                [c["weight_decay"] for c in configs],
            )
            train_gens = [stream_generator(tid, "train", epoch, device) for tid in trial_ids]
            val_gens = [stream_generator(tid, "val", epoch, device) for tid in trial_ids]

            sync(device)
            t0 = time.perf_counter()
            idx_batches = torch.stack([epoch_index_batches(train_idx_dev, batch_size, g)
                                       for g in train_gens])
            state, tm = stacked_step(state, *dataset.device_site_table[:3], idx_batches,
                                     train_gens, betas, gammas)
            tm = metrics_to_host(tm)  # one transfer ends the epoch
            train_s = time.perf_counter() - t0
            vms = _evaluate_stacked(stacked_eval, state, dataset.device_site_table, val_idx,
                                    val_bs, val_gens, betas, gammas)

            steps = int(idx_batches.shape[1])
            for i, (config, vm) in enumerate(zip(configs, vms)):
                val_loss = vm.get("val_loss", float("inf"))
                ckpt_path = str(ckpt_dir / f"trial_{trial_ids[i]}.pt")
                save_reference_checkpoint(
                    ckpt_path, state.lane_state_dict(i), epoch=epoch, best_val=val_loss,
                    args={k: v for k, v in config.items() if not isinstance(v, (list, dict))},
                )
                report(
                    i, epoch + 1,
                    loss=val_loss,
                    val_loss=val_loss,
                    train_loss=float(tm["loss"][i]),
                    val_psnr=vm.get("val_psnr", 0.0),
                    checkpoint=ckpt_path,
                    steps=steps,
                    val_batches=-(-len(val_idx) // val_bs),
                    train_s=train_s,
                    train_patches_per_s=K * steps * batch_size / train_s,
                    lanes=K,
                    max_memory_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                                    if device.type == "cuda" else 0.0),
                    **kernel_launches(),
                )

    return stacked_trainable


def process_trainable(data_spec, config, report):
    """Module-level (picklable) trial of the spawned process executor.

    Its slot's environment is set before torch touches a device: the trial
    sees one card (CUDA_VISIBLE_DEVICES), or the CPU when LIVAE_FORCE_PLATFORM
    is "cpu". It rebuilds the data in its process and loads the kernels the
    parent built; it never builds them.
    """
    device = resolve_device("cpu" if os.environ.get("LIVAE_FORCE_PLATFORM") == "cpu" else None)
    if device.type == "cuda":
        missing = [n for n in _build.SOURCES if not _build.is_built(n)]
        if missing:
            raise RuntimeError(f"kernels {missing} are not built: the parent process builds "
                               "them before it starts a trial")
    ns = argparse.Namespace(**{
        k: data_spec.get(k)
        for k in ("synthetic", "synthetic_size", "synthetic_vacancy_rate",
                  "synthetic_s_amplitude", "data", "dataset_name")
    })
    images = resolve_images(ns)
    normalize = bool(config.get("normalize", True))
    dataset = AdaptiveLatticeDataset(
        images, patch_size=config["patch_size"], padding=config["padding"],
        transform=default_transform, normalize=normalize, device=device,
    )
    ckpt_dir = Path(data_spec["ckpt_dir"])
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # the executor exports a deterministic trial id (not the pid) for seeds and names
    trial_id = int(os.environ.get("LIVAE_TRIAL_ID", os.getpid()))
    compiled = _build_compiled(
        dataset, int(config["patch_size"]), int(config["padding"]), int(config["latent_dim"]),
        float(config.get("grad_max_norm") or 20.0), normalize, device, trial_id,
    )
    ckpt_path = str(ckpt_dir / f"trial_{trial_id}.pt")
    _trial_body(
        config, report, dataset, compiled, ckpt_path, trial_seed=trial_id,
        extra_metrics={"slot": os.environ.get("LIVAE_SWEEP_SLOT", ""), "pid": os.getpid()},
    )


def default_trial_env(slot: int, force_platform: str | None = None,
                      num_devices: int | None = None) -> dict:
    """The environment of process slot `slot`.

    Each slot sees one card, CUDA_VISIBLE_DEVICES = the slot's card (slots
    wrap around the cards this process sees, so on a one-card host every slot
    shares card 0); `force_platform="cpu"` puts the trial on the CPU instead.
    `num_devices` defaults to the cards this process sees.
    """
    env = {"LIVAE_SWEEP_SLOT": str(slot)}
    if force_platform:
        env["LIVAE_FORCE_PLATFORM"] = force_platform
        return env
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = [c for c in visible.split(",") if c] if visible else None
    if not cards:
        n = num_devices if num_devices is not None else max(1, torch.cuda.device_count())
        cards = [str(i) for i in range(n)]
    env["CUDA_VISIBLE_DEVICES"] = cards[slot % len(cards)]
    return env


def run_hyperparameter_search(args) -> dict:
    """Run the sweep; returns {"trials", "best", "seconds", "kernel_build_s",
    "launches", "max_memory_gib"} (launches and memory of this process), which
    it also prints as one `sweep_summary {json}` line."""
    try:
        import ray  # noqa: F401

        print("note: Ray detected but the native engine is used for the trials")
    except ImportError:
        pass
    t_start = time.perf_counter()
    device = resolve_device("cpu" if args.cpu else None)
    kernel_build_s = prebuild_kernels(device)

    param_space = {
        "lr": loguniform(args.lr_min, args.lr_max),
        "latent_dim": choice(args.latent_dims),
        "beta": loguniform(args.beta_min, args.beta_max),
        "weight_decay": loguniform(args.weight_decay_min, args.weight_decay_max),
        "batch_size": choice(args.batch_sizes),
        # per-patch min-max normalization: searched with --search-norm
        "normalize": (choice([True, False]) if args.search_norm else not args.no_per_patch_norm),
        # rotation-diversity weight (0: the reference trial's plain VAE loss)
        "gamma": (loguniform(args.gamma_min, args.gamma_max) if args.search_gamma
                  else args.gamma),
        # fixed parameters
        "patch_size": args.patch_size,
        "padding": args.padding,
        "val_split": args.val_split,
        "epochs": args.epochs,
        "beta_annealing": args.beta_annealing,
        "beta_annealing_epochs": args.beta_annealing_epochs,
        "grad_max_norm": args.grad_max_norm,
    }

    if args.scheduler == "asha":
        grace = min(args.grace_period, max(1, args.epochs // 2))
        scheduler = ASHAScheduler(metric="loss", mode="min", max_t=args.epochs,
                                  grace_period=grace, reduction_factor=args.reduction_factor)
        print(f"ASHA: grace={grace}, max_t={args.epochs}, rf={args.reduction_factor}")
    elif args.scheduler == "pbt":
        scheduler = PBTScheduler(
            metric="loss", mode="min", perturbation_interval=args.perturbation_interval,
            hyperparam_mutations={"lr": loguniform(args.lr_min, args.lr_max),
                                  "beta": loguniform(args.beta_min, args.beta_max)},
        )
        print(f"PBT: interval={args.perturbation_interval}")
    else:
        scheduler = None

    results_dir = Path(args.ray_results_dir) / args.experiment_name
    executor = None if args.executor in (None, "auto") else args.executor
    trial_env = None
    if executor == "process":
        # a module-level trainable; the children rebuild the data from this spec
        data_spec = {
            "synthetic": args.synthetic,
            "synthetic_size": args.synthetic_size,
            "synthetic_vacancy_rate": args.synthetic_vacancy_rate,
            "synthetic_s_amplitude": args.synthetic_s_amplitude,
            "data": args.data,
            "dataset_name": args.dataset_name,
            "ckpt_dir": str(results_dir / "checkpoints"),
        }
        trainable = functools.partial(process_trainable, data_spec)
        trial_env = functools.partial(default_trial_env,
                                      force_platform="cpu" if args.cpu else None)
    elif args.stacked <= 1:
        trainable = make_trainable(args, resolve_images(args), device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.stacked > 1:
        # K trials in one vmapped program; early-stopping schedulers do not apply
        if scheduler is not None:
            print(f"note: --stacked ignores --scheduler {args.scheduler} (lanes share one "
                  "program; every trial runs its full epoch budget)")
        if executor is not None:
            print(f"note: --stacked replaces --executor {executor}")
        trials = run_search_stacked(
            make_stacked_trainable(args, resolve_images(args), device), param_space,
            num_samples=args.num_samples, stack_size=args.stacked, metric="loss", mode="min",
            results_dir=results_dir, seed=args.seed, search_alg=args.search_alg,
        )
    else:
        trials = run_search(
            trainable, param_space, num_samples=args.num_samples, scheduler=scheduler,
            metric="loss", mode="min", results_dir=results_dir, seed=args.seed,
            search_alg=args.search_alg, max_concurrent=args.max_concurrent, executor=executor,
            trial_env=trial_env,
        )
    sync(device)
    summary = {
        "trials": trials, "best": get_best_result(trials, metric="loss", mode="min"),
        "seconds": time.perf_counter() - t_start, "kernel_build_s": kernel_build_s,
        "launches": kernel_launches(),
        "max_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else 0.0),
    }

    print("sweep_summary " + json.dumps(
        {"trials": len(trials), "pid": os.getpid(),
         **{k: summary[k] for k in ("seconds", "kernel_build_s", "launches", "max_memory_gib")}}))
    best = summary["best"]
    print("\n" + "=" * 80)
    print("HYPERPARAMETER SEARCH COMPLETE")
    print("=" * 80)
    if best is None:
        print("No successful trials completed.")
        return summary
    print("\nBest trial config:")
    for k, v in best.config.items():
        print(f"  {k}: {v}")
    print(f"\nBest trial metrics: val_loss={best.best('val_loss', 'min'):.4f}")
    print(f"Best checkpoint: {best.checkpoint}")

    if args.save_best_config:
        config_path = Path(args.save_best_config)
        config_path.parent.mkdir(parents=True, exist_ok=True)
        save_config = {k: v for k, v in best.config.items()
                       if not callable(v) and k != "h5_paths"}
        config_path.write_text(json.dumps(save_config, indent=2))
        print(f"\nBest config saved to: {config_path}")
    return summary


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Hyperparameter search for RVAE (GPU)")
    add_data_flags(parser)
    parser.add_argument("--patch-size", type=int, default=128)
    parser.add_argument("--padding", type=int, default=32)
    parser.add_argument("--val-split", type=float, default=0.1)
    parser.add_argument("--lr-min", type=float, default=1e-5)
    parser.add_argument("--lr-max", type=float, default=2e-3)
    # the reference's search-space defaults
    parser.add_argument("--latent-dims", type=int, nargs="+", default=[8, 16, 32, 64])
    parser.add_argument("--beta-min", type=float, default=0.1)
    parser.add_argument("--beta-max", type=float, default=2.0)
    parser.add_argument("--weight-decay-min", type=float, default=1e-6)
    parser.add_argument("--weight-decay-max", type=float, default=1e-3)
    parser.add_argument("--batch-sizes", type=int, nargs="+", default=[512])
    parser.add_argument(
        "--no-per-patch-norm",
        action="store_true",
        help="Train all trials without the per-patch min-max normalization "
        "(BASELINE.md vacancy recipe)",
    )
    parser.add_argument(
        "--search-norm",
        action="store_true",
        help="Make per-patch normalization a searchable choice([True, False])",
    )
    parser.add_argument(
        "--gamma", type=float, default=0.0,
        help="Fixed rotation-diversity weight (0 = reference trial's VAELoss)",
    )
    parser.add_argument("--search-gamma", action="store_true")
    parser.add_argument("--gamma-min", type=float, default=1.0)
    parser.add_argument("--gamma-max", type=float, default=20.0)
    parser.add_argument("--epochs", type=int, default=310)
    parser.add_argument("--beta-annealing", action="store_true")
    parser.add_argument("--beta-annealing-epochs", type=int, default=10)
    parser.add_argument("--grad-max-norm", type=float, default=None)
    parser.add_argument("--num-samples", type=int, default=50)
    parser.add_argument(
        "--max-concurrent",
        type=int,
        default=4,
        help="Trials in flight at once (the fractional-GPU packing analog)",
    )
    parser.add_argument(
        "--executor",
        choices=["auto", "sequential", "thread", "process"],
        default=None,
        help="Trial executor: thread (default when --max-concurrent > 1) shares the card; "
        "process spawns one worker per trial, each slot pinned to a card by "
        "CUDA_VISIBLE_DEVICES",
    )
    parser.add_argument(
        "--stacked",
        type=int,
        default=0,
        help="Train K trials at once in one vmapped program (per-lane lr/wd/beta/gamma/"
        "seed; structural params group into separate stacks). Replaces "
        "--executor/--scheduler; tune K so K x batch-size fits the card's memory",
    )
    parser.add_argument("--cpus-per-trial", type=int, default=8, help=argparse.SUPPRESS)
    parser.add_argument("--gpus-per-trial", type=float, default=0.25, help=argparse.SUPPRESS)
    parser.add_argument("--scheduler", choices=["asha", "pbt", "none"], default="asha")
    # the reference's HyperOptSearch; "hyperopt" resolves to the native TPE
    parser.add_argument(
        "--search-alg", choices=["hyperopt", "tpe", "random"], default="hyperopt"
    )
    parser.add_argument("--grace-period", type=int, default=30)
    parser.add_argument("--reduction-factor", type=int, default=3)
    parser.add_argument("--perturbation-interval", type=int, default=5)
    parser.add_argument("--experiment-name", type=str, default="rvae_tune")
    parser.add_argument("--ray-results-dir", type=str, default="ray_results")
    parser.add_argument(
        "--save-best-config", type=str, default="checkpoints/best_config.json"
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (plain PyTorch)")
    return parser


if __name__ == "__main__":
    run_hyperparameter_search(build_argparser().parse_args())
