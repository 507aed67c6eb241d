#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (livae_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from ops/csrc with nvcc, one process per source, all
   started together.
3. Kernel phases, at [512, 256, 256] in bfloat16 and float32, with the shifts
   of real rotations, integer shifts and random shifts; kernels and plain
   versions are timed with CUDA events:
   * rot3: the forward and backward kernels against `rot3_reference` and
     autograd through it (forward and dx bit-equal), also at the shapes the
     other driven paths give it (PATH_SHAPES: PatchDataset's rotation, the
     ragged val batch, the analysis's batches and probes) and at edge canvases
     [3, P, P] for P in 2, 33, 130, 255 and MAX_P; the dx-free backward gives
     the deltas' bits; times for each cluster size that fits;
   * shear (kernel C), along both axes: the forward against
     `fractional_shift_reference` (bit-equal), the fused backward against
     `fractional_shift_vjp_reference` (dx bit-equal) and against autograd
     through the plain version, also at edge shapes [3, P, P] for P in 2, 33,
     130, 255, 432, 640 and 1024 and [3, 33, 130]; the dx-free backward gives
     d delta's bits; times in f32 and bf16 on both axes under rotation and
     random shifts, with the launch plan, blocks per SM, share of the bound
     and a copy_ of the same bytes beside each;
   * upconv (ops/csrc/upconv.cu): the decoder stage's epilogue and its adjoint
     (U) at the four stages' shapes of batch 512 and the STN blocks' phase max
     and its routing (P) at [1024, 64 | 128, 64 | 32, 64 | 32], and at edge
     shapes (n = 2, C_out = 1, rectangular, one-pixel maps), in bf16 and f32
     with TF32 off, against the plain versions and autograd through them
     (forwards, g_y and the routing bit-equal; a tie-heavy case for P); the
     whole fused stage and block against the unfused chains in f32; times in
     bf16 beside the plain versions, the unfused chain and the whole fused
     stage or block; one stage's and one block's launches both ways.
4. Agreement phase: the f32 model on the card (kernels) against the same
   weights on the CPU (plain versions, which tests/test_torch_*.py hold
   against the JAX package) on a small batch.
5. Main path: PairedAdaptiveLatticeDataset on the bench frame, RVAE at patch
   128 / latent 16 / bfloat16, 2 epochs of fused paired training at batch 512
   (AdamW 1e-3, weight decay 1e-5, beta = gamma = 10, canonical weight 0.2,
   clip 20), each followed by the fused eval over 2 val batches, then a fused
   encode. Every train step must launch the rot3 forward 3 times, its
   backward twice, no shear kernel, the upconv epilogue 4 times each way
   (one per decoder stage) and the phase max twice each way (one per STN
   block); each eval batch the forwards of the same, each encode batch one
   rot3 forward and the two phase maxes.
6. Rotation paths: `rotate_image_fast(backend="shear")` against "fused" on
   [512, 1, 128, 128] (canvas 256) in f32 and bf16, and both backends timed
   in f32, forward and forward+backward; a [64, 3, 128, 128]
   rotation under "auto" (kernel C, not rot3); three fused paired train steps
   of `RVAE(fast_resample=False)` at batch 512 in bf16 (rot3 only for the
   augmentation); `python -m livae_tpu_torch.bench_rotate --reps 3`.
7. The training entry points, each `run_training(args)` in-process with parsed
   arguments, on two 1024-pixel synthetic frames (`--synthetic 2
   --val-split 0.25`), at the defaults otherwise (patch 128, padding 32,
   latent 16, batch 512, bf16):
   * `livae_tpu_torch.scripts.train_rvae`, 3 epochs with an STN learning
     rate, beta annealing and a resume checkpoint per epoch: per epoch 3 rot3
     forward launches per train step and per val batch (the ragged tail too),
     2 backward per step, no shear launch; finite metrics; beta 0, 0, 5; the
     optimizer's rates at each epoch's first step are the two cosine
     schedules'; best and `_final` checkpoints with the payload's five keys;
     a fresh model loaded from `_final` encodes bit-equal. Then `--epochs 4
     --resume`: it starts at epoch 3 from the state whose digest epoch 2
     printed, with beta 10 and a finite loss;
   * `livae_tpu_torch.scripts.train_vae`, 3 epochs: no kernel launch, finite
     metrics, checkpoints that load strictly.
8. The analysis path, on train_rvae's `_final` checkpoint and the same two
   frames, at the scripts' defaults (float32, padding 16):
   * analysis: `visualizations.collect_stats` over every site at batch 256
     (2 rot3 forwards per batch, the ragged tail too), twice, with the encode
     rate; `verify_rotational_invariance` on 32 probes (3 rot3 forwards);
     collect_stats' mu against `make_fused_encode`'s, and one batch with the
     noise injected against the CPU port, at 2e-4; the t-SNE embedding, the
     KMeans clustering and the plots of `visualizations` and
     `plot_tsne_by_image` where sklearn and matplotlib are importable, else a
     line naming each step skipped;
   * rotation_invariance: `evaluate_rotation_invariance` on 64 probes, eight
     angles (4 rot3 forwards each), the noise injected, against the CPU port
     at 2e-4;
   * pretrain_stn: `run_pretrain` for 2 epochs (1 rot3 forward per batch, no
     backward), the checkpoint holding exactly `stn_spec`'s keys, then
     `train_rvae --stn-checkpoint` for an epoch from it.
9. Three fused VAE steps on `PatchDataset(patch_size=128)` (rotation
   augmentation: 1 rot3 forward per step, no backward); the f32 VAE on the
   card against the CPU port at 2e-4; `python -m livae_tpu_torch.bench` as a
   subprocess, whose stdout must be one JSON line.
10. device_peaks: `build_adaptive_lattice(device_peaks=True)` against the
   host build on the bench frame (1409 sites) and on a 2048-pixel frame:
   the atoms equal the host's in its order, the tables equal row for row and
   as lexsorted sets, the card's table equals the CPU port's; build seconds
   and the final max_peaks; `bandpass_filter`,
   `fft_spectra` and `normalize_image` on the 2048 frame, card against CPU.
11. host_loop: `train_rvae_one_epoch` (4 batches) and `evaluate_rvae` (2) over
   the bench dataset's `iter_epoch`, `train_one_epoch` (4) and `evaluate` (2)
   with the plain VAE on `PatchDataset`, at batch 512 in bf16; finite epoch
   means and their launches.
12. sweep: `python -m livae_tpu_torch.scripts.train_rvae_raytune` as a process
   on the entry points' data at the CLI's widths: ASHA with the native TPE (4
   trials, 2 at a time, 3 epochs, grace 1), PBT (4 trials, 2 at a time,
   interval 1; a donor checkpoint must be loaded), and the process executor
   (1 trial, 1 epoch); every trial done or stopped with finite losses, the
   JAX script's best_config.json keys, each run's rot3 launches (2 forward and
   2 backward per train step, 2 forward per val batch); then
   `train_rvae_with_best --override-epochs 1` in-process on the ASHA run's
   best config (its checkpoint loads), `compare_training_methods`, and
   `analyze_raytune_results` where pandas is importable.
13. stacked: `train_rvae_raytune --stacked 4` in-process on the sweep's data
   at the CLI's widths (4 lanes of batch 512, 2 epochs, bf16): every trial
   done, a checkpoint per lane, rot3's launches per epoch 2 per train step
   and 2 per val batch forward and 2 per train step backward, whatever K;
   lane 0's first epoch in f32 (TF32 off) against trial 0's sequential fused
   step at 2e-4; rot3 under torch.func.vmap (one launch on the folded batch)
   against the plain version lane by lane at [2 | 4 | 8, 512, 256, 256] and
   [4, 193, 256, 256] (forward and dx bit-equal), and
   `rotate_image_fast(backend="shear")` under vmap on [2, 64, 3, 128, 128].
14. compare: `compare_vae_rvae` at its defaults, `compare_resample_elbo
   --synthetic 1 --train-epochs 1` (the relative delta against the ELBO gate
   of BASELINE.json), `accuracy_program` with one config for 2 epochs on one
   training frame at the CLI's widths (its sklearn metrics skipped, and said
   so, where sklearn is not importable); each one's rot3 launches.
15. exports: the JAX package's 40 names imported from `livae_tpu_torch`, an
   RVAE built and run on the card through them (2 rot3 forwards).
16. parallel: world size 1 under NCCL (3 fused rVAE steps at batch 512, bf16,
   through DistributedDataParallel, and one sharded eval batch) against the
   same without a mesh: weights equal, metrics within 1e-6; then 2 gloo ranks
   spawned on the one card (NCCL refuses two ranks on one device), CUDA
   tensors, f32, 2 steps, diversity off (gloo gathers no CUDA tensor),
   against one process: step means within 1e-5, weights within 1e-5 but for
   under 0.1 % (Adam's near-zero-gradient flips); rot3 3 / 2 per step.
17. tensor_parallel: 2 gloo ranks spawned on the one card as 1 data x 2 model
   ways (the large dense layers split Megatron-style), CUDA tensors, f32 at
   the main path's widths, 2 fused steps with the diversity term and one
   fused eval batch (on the one process's weights, sliced again) against one
   process: means within 1e-5, gathered weights within 1e-5 but for under
   0.1 % (Adam's flips); rot3 3 / 2 per step and 3
   per eval batch on rank 0; rank 0 holds 925,696 fewer parameters; the
   gathered state loads into a plain RVAE that encodes as the split one.
18. profile: `python -m livae_tpu_torch.profile_step --path paired vae patch
   encode stacked --steps 2` as a process (its report printed), then
   `profile_components --reps 3` in this process.
Around each driven path the launch counters are zeroed just before and read
just after (a sweep's processes report their own); every RVAE decoder pass
adds 4 upconv launches each way, every STN localisation pass 2 phase-max
launches each way. A `phase_seconds` line
gives each phase's wall-clock seconds. The build step prints each kernel's registers and spills (ptxas);
the rot3 phase prints each cluster size's time, shared memory per block,
resident clusters and share of the bound. Then it prints one
{"kernels": [...]} line (kernel C's figures are f32 along axis 2 with the
shifts of real rotations, the per-shear path's case; "cases" holds the
others; the upconv kernels' figures are bf16 and sum one decoder or
localisation pass, beside the whole fused stage or block, `stage_ms`, and the
unfused chain it replaces, `unfused_ms`; "cases" holds each stage and block)
and, last, the
{"ok": true, "device": {...}} line.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without CUDA or without the package.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from livae_tpu_torch import bench_rotate
from livae_tpu_torch.data.datasets import (
    AdaptiveLatticeDataset,
    PairedAdaptiveLatticeDataset,
    PatchDataset,
    default_transform,
)
from livae_tpu_torch.data.pipeline import PairedDraws, sample_paired_draws
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE, _reflect_pad1, _upsample2x
from livae_tpu_torch.models.vae import VAE
from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import rot3 as R
from livae_tpu_torch.ops import shear as SH
from livae_tpu_torch.ops import upconv as UP
from livae_tpu_torch.ops.fft import (
    bandpass_filter,
    fft_spectra,
    host_bandpass_normalize,
    normalize_image,
)
from livae_tpu_torch.ops.lattice import (
    build_adaptive_lattice,
    detect_atoms_device,
    estimate_lattice_constant,
)
from livae_tpu_torch.ops.peaks import get_clean_peaks
from livae_tpu_torch.ops.resample import aligned_margin, rotate_image_fast
from livae_tpu_torch.scripts import (
    analyze_raytune_results,
    compare_training_methods,
    plot_tsne_by_image,
    pretrain_stn,
    train_rvae,
    train_rvae_with_best,
    train_vae,
    verify_rotational_invariance,
    visualizations,
)
from livae_tpu_torch.train.engine import (
    MetricLogger,
    evaluate,
    evaluate_rotation_invariance,
    evaluate_rvae,
    make_eval_step,
    make_fused_encode,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    make_fused_vae_train_step,
    make_rvae_eval_step,
    make_rvae_train_step,
    make_train_step,
    metrics_to_host,
    train_one_epoch,
    train_rvae_one_epoch,
)
from livae_tpu_torch.train.state import make_optimizer
from livae_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_reference_checkpoint,
    stn_spec,
)

SHAPE = (512, 256, 256)  # rot3's canvas on the main path at batch 512, patch 128
PATCH, LATENT, BATCH, PADDING = 128, 16, 512, 32
STEPS_PER_EPOCH, EPOCHS, VAL_BATCHES, ENCODE_STEPS = 6, 2, 2, 4
EXACT_STEPS = 3
PATCH_DATASET_STEPS = 3
# the entry points' data: two bench frames, a quarter of the sites held out
FRAMES = ["--synthetic", "2", "--synthetic-size", "1024"]
CLI_DATA = [*FRAMES, "--val-split", "0.25", "--no-tensorboard"]
ANALYSIS_BATCH, INVARIANCE_PROBES, ROTATION_PROBES = 256, 32, 64  # the scripts' defaults
PRETRAIN_EPOCHS = 2
NO_LAUNCH = {"rot3_fwd": 0, "rot3_bwd": 0, "shear_fwd": 0, "shear_bwd": 0,
             "upconv_fwd": 0, "upconv_bwd": 0, "phasemax_fwd": 0, "phasemax_bwd": 0}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def zero_counts() -> None:
    R.FWD_LAUNCHES = R.BWD_LAUNCHES = SH.FWD_LAUNCHES = SH.BWD_LAUNCHES = 0
    UP.UP_FWD_LAUNCHES = UP.UP_BWD_LAUNCHES = UP.PMAX_FWD_LAUNCHES = UP.PMAX_BWD_LAUNCHES = 0


def counts() -> dict[str, int]:
    return {"rot3_fwd": R.FWD_LAUNCHES, "rot3_bwd": R.BWD_LAUNCHES,
            "shear_fwd": SH.FWD_LAUNCHES, "shear_bwd": SH.BWD_LAUNCHES,
            "upconv_fwd": UP.UP_FWD_LAUNCHES, "upconv_bwd": UP.UP_BWD_LAUNCHES,
            "phasemax_fwd": UP.PMAX_FWD_LAUNCHES, "phasemax_bwd": UP.PMAX_BWD_LAUNCHES}


def rvae(decode: int = 0, decode_bwd: int = 0, localize: int = 0, localize_bwd: int = 0,
         **rot3) -> dict[str, int]:
    """The launches of an RVAE's passes: each decoder forward launches the
    upconv epilogue 4 times (one per stage) and each backward 4 times; each STN
    localisation pass (one batch, or the paired [2B] one) launches the phase
    max twice (one per block), each backward twice; plus the rot3 counts given."""
    return {"upconv_fwd": 4 * decode, "upconv_bwd": 4 * decode_bwd,
            "phasemax_fwd": 2 * localize, "phasemax_bwd": 2 * localize_bwd, **rot3}


# per fused paired train step (the extraction's rotation, the STN's and the inverse
# one, two backward; one decoder and one paired localisation pass, each backward),
# per fused paired eval batch, and per encode batch (the STN's rotation)
PAIRED_STEP = rvae(1, 1, 1, 1, rot3_fwd=3, rot3_bwd=2)
PAIRED_EVAL = rvae(1, 0, 1, 0, rot3_fwd=3)
ENCODE_BATCH = rvae(0, 0, 1, 0, rot3_fwd=1)


def launches_of(*terms) -> dict[str, int]:
    """NO_LAUNCH plus n times the counts of `per` for each (per, n) in terms."""
    out = dict(NO_LAUNCH)
    for per, n in terms:
        for k, v in per.items():
            out[k] += n * v
    return out


def median_ms(fn, reps: int = 7, warmup: int = 3, inner: int = 10) -> float:
    """Median over `reps` CUDA-event windows of the time per call of fn, each
    window `inner` calls back to back (so the host's launch latency overlaps the
    device's work), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _deltas(kind: str, gen, B: int, P: int):
    """Shift pairs [B, P]: those of real rotations (|phi| <= pi/4, as
    rotate_image_fast makes them), integers (f == 0), or independent random
    shifts per row and column (the hardest access pattern)."""
    dev = gen.device
    if kind == "rotation":
        phi = (torch.rand(B, device=dev, generator=gen) - 0.5) * (torch.pi / 2)
        pos = torch.arange(P, dtype=torch.float32, device=dev) - (P - 1) / 2.0
        return -torch.tan(phi / 2)[:, None] * pos, torch.sin(phi)[:, None] * pos
    if kind == "integer":
        return tuple(torch.randint(-5, 6, (B, P), device=dev, generator=gen).float()
                     for _ in range(2))
    return ((torch.rand((B, P), device=dev, generator=gen) - 0.5) * 106.0,
            (torch.rand((B, P), device=dev, generator=gen) - 0.5) * 180.0)


EDGE_B, EDGE_P = 3, (2, 33, 130, 255, R.MAX_P)  # ragged bands, clusters below 8
# rot3's other shapes on the driven paths: the canvas of PatchDataset's rotation
# (padded patch 136 plus a margin of 136 // 6 each side), the ragged last val
# batch of train_rvae and pretrain_stn (705 val sites at batch 512), the
# analysis's batches of 256 (the STN's and the inverse rotation) and its ragged
# tail (225 of the 3041 sites the two frames give at padding 16), and the probes
# of check_invariance and evaluate_rotation_invariance; compare_resample_elbo's
# batches of 140 (the bench frame's 140 val sites), accuracy_program's held-out
# tail (1446 sites at batch 512) and compare_vae_rvae's batch of 32 at patch 64
# (canvas 128). The pretraining's train batches are SHAPE. The phases that
# drive them check that their shape is held here; the stacked phase holds its
# folded batches under vmap (VMAP_ROT3_LANES).
PATH_SHAPES = [(512, 180, 180), (193, 256, 256), (256, 256, 256), (225, 256, 256),
               (INVARIANCE_PROBES, 256, 256), (ROTATION_PROBES, 256, 256),
               (140, 256, 256), (422, 256, 256), (32, 128, 128)]


def _rot3_errors(x, w, d_row, d_col):
    """rot3's kernels against `rot3_reference` and autograd through it on one
    input: (forward error, [dx, d_row, d_col] errors, gradient scales). Also
    checks that the dx-free backward gives the deltas' bits."""
    y = R.Rot3Function.apply(x, d_row, d_col)
    y_ref = R.rot3_reference(x, d_row, d_col)
    ins = [t.clone().requires_grad_(True) for t in (x, d_row, d_col)]
    gk = torch.autograd.grad(R.Rot3Function.apply(*ins), ins, w)
    gr = torch.autograd.grad(R.rot3_reference(*ins), ins, w)
    _, ddr_free, ddc_free = R._launch_bwd(x, d_row, d_col, w, with_dx=False)
    _, ddr_full, ddc_full = R._launch_bwd(x, d_row, d_col, w, with_dx=True)
    torch.cuda.synchronize()
    check(torch.equal(ddr_free, ddr_full) and torch.equal(ddc_free, ddc_full),
          f"dx-free rot3 backward changes the deltas at {list(x.shape)} {x.dtype}")
    fe = (y.float() - y_ref.float()).abs().max().item()
    ge = [(a.float() - b.float()).abs().max().item() for a, b in zip(gk, gr)]
    scale = [b.float().abs().max().item() for b in gr]
    return fe, ge, scale


def kernel_phase():
    """Hold both rot3 kernels against the plain version at the main path's
    shape, at the other driven paths' shapes and at edge canvases; time them at
    bf16 for each cluster size."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P, _ = SHAPE
    # f32 references in full f32 (no TF32 anywhere in rot3; set for the record)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"fwd": 0.0, "bwd": 0.0}
    for shape in [SHAPE] + PATH_SHAPES + [(EDGE_B, p, p) for p in EDGE_P]:
        for dtype in (torch.bfloat16, torch.float32):
            for kind in ("rotation", "integer", "random"):
                x = torch.randn(shape, device=dev, generator=gen).to(dtype)
                w = torch.randn(shape, device=dev, generator=gen).to(dtype)
                d_row, d_col = _deltas(kind, gen, shape[0], shape[1])
                fe, ge, scale = _rot3_errors(x, w, d_row, d_col)
                # forward and dx: the same f32 operations with no FMA contraction,
                # so bit-equal. d_row/d_col: sums of P products in another order.
                tol_d = [1e-4 * max(1.0, s) for s in scale[1:]]
                print(f"rot3 {list(shape)} {str(dtype)[6:]:8s} {kind:8s} fwd max_abs_err {fe:.3e}"
                      f" (tol 0) dx {ge[0]:.3e} (tol 0) d_row {ge[1]:.3e} (tol {tol_d[0]:.1e})"
                      f" d_col {ge[2]:.3e} (tol {tol_d[1]:.1e})")
                what = f"{list(shape)} {dtype} {kind}"
                check(fe == 0.0, f"rot3 forward {what}")
                check(ge[0] == 0.0, f"rot3 backward dx {what}")
                check(ge[1] <= tol_d[0] and ge[2] <= tol_d[1], f"rot3 backward deltas {what}")
                err["fwd"] = max(err["fwd"], fe)
                err["bwd"] = max(err["bwd"], *ge)

    n, io, dl = B * P * P, 2, 4 * B * P  # bf16 I/O
    bound = {
        "fwd": max((2 * n * io + 2 * dl) / HBM_BYTES_PER_S, 12 * n / F32_FLOP_PER_S) * 1e3,
        "bwd": max((3 * n * io + 4 * dl) / HBM_BYTES_PER_S, 29 * n / F32_FLOP_PER_S) * 1e3,
    }
    # times at the main path's dtype, for each cluster size that fits; the shifts
    # of real rotations (the line's figures, last) and random shifts (the record)
    x = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    g = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    ms = {}
    for kind in ("random", "rotation"):
        d_row, d_col = _deltas(kind, gen, B, P)
        for k, sizes in (("fwd", (2, 4, 8)), ("bwd", (4, 8))):
            for size in sizes:
                plan = R.launch_plan(P, k, size)
                if plan.cluster != size:
                    continue
                fn = ((lambda: R._launch_fwd(x, d_row, d_col, size)) if k == "fwd" else
                      (lambda: R._launch_bwd(x, d_row, d_col, g, True, size)))
                t = median_ms(fn)
                print(f"rot3_{k} bf16 {list(SHAPE)} {kind} shifts, cluster {size}: {t:.4f} ms, "
                      f"{plan.smem} B shared memory per block, "
                      f"{R.active_clusters(plan, k)} clusters resident, "
                      f"{100 * bound[k] / t:.1f} % of bound")
        plan = {k: R.launch_plan(P, k) for k in ("fwd", "bwd")}
        ms["fwd"] = median_ms(lambda: R._launch_fwd(x, d_row, d_col))
        ms["bwd"] = median_ms(lambda: R._launch_bwd(x, d_row, d_col, g))
        ms["bwd_nodx"] = median_ms(lambda: R._launch_bwd(x, d_row, d_col, g, False))
        print(f"rot3 kernels, bf16 {list(SHAPE)}, {kind} shifts, planned clusters "
              f"{plan['fwd'].cluster} / {plan['bwd'].cluster}: forward {ms['fwd']:.4f} ms, "
              f"backward {ms['bwd']:.4f} ms, backward without dx {ms['bwd_nodx']:.4f} ms")
    ms["fwd_plain"] = median_ms(lambda: R.rot3_reference(x, d_row, d_col), reps=3)
    ins = [t.clone().requires_grad_(True) for t in (x, d_row, d_col)]
    y_ref = R.rot3_reference(*ins)
    ms["bwd_plain"] = median_ms(
        lambda: torch.autograd.grad(y_ref, ins, g, retain_graph=True), reps=3)

    for k in ("fwd", "bwd"):
        p = R.launch_plan(P, k)
        print(f"rot3_{k} bf16 {list(SHAPE)}: kernel {ms[k]:.4f} ms, plain {ms[k + '_plain']:.4f} ms,"
              f" bound {bound[k]:.4f} ms (bytes), {100 * bound[k] / ms[k]:.1f} % of bound; "
              f"cluster {p.cluster}, {p.rows} rows and {p.smem} B shared memory per block")
    return err, ms, bound


SHEAR_EDGE = [(EDGE_B, p, p) for p in (2, 33, 130, 255, R.MAX_P, 640, 1024)] + [(EDGE_B, 33, 130)]


def _shear_errors(x, g, delta, axis):
    """Kernel C against the plain versions on one input: (forward, dx, d delta,
    dx against autograd, d delta against autograd) errors and the tolerances
    of the last three. Also checks that the dx-free backward gives d delta's
    bits."""
    ulp = 2.0**-7 if x.dtype == torch.bfloat16 else 2.0**-23
    ins = [t.clone().requires_grad_(True) for t in (x, delta)]
    y = SH.FractionalShiftFunction.apply(*ins, axis)
    dx, dd = torch.autograd.grad(y, ins, g)
    y_ref = SH.fractional_shift_reference(x, delta, axis)
    dx_v, dd_v = SH.fractional_shift_vjp_reference(x, delta, g, axis)
    dx_a, dd_a = torch.autograd.grad(SH.fractional_shift_reference(*ins, axis), ins, g)
    _, dd_free = SH._launch_bwd(x, delta, g, axis, with_dx=False)
    torch.cuda.synchronize()
    check(torch.equal(dd_free, dd), f"dx-free shear backward changes d delta at "
                                    f"{list(x.shape)} {x.dtype} axis {axis}")
    e = {"fwd": (y.float() - y_ref.float()).abs().max().item(),
         "dx": (dx.float() - dx_v.float()).abs().max().item(),
         "dd": (dd - dd_v).abs().max().item(),
         "dx_a": (dx.float() - dx_a.float()).abs().max().item(),
         "dd_a": (dd - dd_a).abs().max().item()}
    # forward and dx: the same f32 operations with no FMA contraction, so
    # bit-equal. dx against autograd: the -delta shift rounds 1 - f once more
    # where |delta| < 1, a few ulps of g. d delta: sums of n products in another
    # order. Autograd's d delta does not round g1 - g0 to bf16 as the JAX formula
    # does, so it is held only in f32.
    tol = {"dx_a": 4 * ulp * g.float().abs().max().item(),
           "dd": 1e-4 * max(1.0, dd_v.abs().max().item())}
    return e, tol


def _shear_bound_ms(shape, axis, elem, direction):
    """Least time at 3.35 TB/s: x (and g) read once, out (dx) written once, the
    deltas read (and d delta written) once; the ~4-7 FLOP per element are far
    below the f32 rate."""
    B, H, W = shape
    n, dl = B * H * W, 4 * B * (H if axis == 2 else W)
    byts = {"fwd": 2 * n * elem + dl, "bwd": 3 * n * elem + 2 * dl,
            "bwd_nodx": 2 * n * elem + 2 * dl}[direction]
    ops = {"fwd": 4, "bwd": 7, "bwd_nodx": 4}[direction] * n
    return max(byts / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def shear_kernel_phase():
    """Hold kernel C's forward and fused backward against the plain versions on
    both axes, in bf16 and f32, at the main shape and at SHEAR_EDGE; time them
    at the main shape under the shifts of real rotations and random shifts."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"fwd": 0.0, "bwd": 0.0}
    for shape in [SHAPE] + SHEAR_EDGE:
        B, H, W = shape
        for dtype in (torch.bfloat16, torch.float32):
            for axis in (2, 1):
                plans = [SH.launch_plan(*shape, axis, k, dtype) for k in ("fwd", "bwd")]
                for kind in ("rotation", "integer", "random"):
                    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
                    g = torch.randn(shape, device=dev, generator=gen).to(dtype)
                    delta = (_deltas(kind, gen, B, H)[0] if axis == 2 else
                             _deltas(kind, gen, B, W)[1])
                    e, tol = _shear_errors(x, g, delta, axis)
                    print(f"shear {list(shape)} {str(dtype)[6:]:8s} axis {axis} {kind:8s} "
                          f"fwd {e['fwd']:.3e} (tol 0) dx {e['dx']:.3e} (tol 0) "
                          f"dx-autograd {e['dx_a']:.3e} (tol {tol['dx_a']:.1e}) "
                          f"d_delta {e['dd']:.3e} (tol {tol['dd']:.1e}) "
                          f"d_delta-autograd {e['dd_a']:.3e}; plans "
                          + " / ".join(f"{p.variant} {p.tile} {p.smem} B" for p in plans))
                    what = f"{list(shape)} {dtype} axis {axis} {kind}"
                    check(e["fwd"] == 0.0, f"shear forward {what}")
                    check(e["dx"] == 0.0, f"shear backward dx {what}")
                    check(e["dx_a"] <= tol["dx_a"], f"shear backward dx vs autograd {what}")
                    check(e["dd"] <= tol["dd"], f"shear backward d_delta {what}")
                    if dtype == torch.float32:
                        check(e["dd_a"] <= tol["dd"], f"shear d_delta vs autograd {what}")
                    err["fwd"] = max(err["fwd"], e["fwd"])
                    err["bwd"] = max(err["bwd"], e["dx"], e["dd"])

    # times at the main shape, beside a copy_ of the same bytes
    B, P, _ = SHAPE
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
        g = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
        flat = torch.empty(3 * x.numel() // 2, device=dev, dtype=dtype)
        y, yflat = torch.empty_like(x), torch.empty_like(flat)
        copy = {"fwd": median_ms(lambda: y.copy_(x)),
                "bwd": median_ms(lambda: yflat.copy_(flat))}
        name = str(dtype)[6:]
        print(f"copy_ {name}: {x.numel() * x.element_size() / 2**20:.0f} MiB each way "
              f"{copy['fwd']:.4f} ms, 1.5x that {copy['bwd']:.4f} ms")
        for axis in (2, 1):
            for kind in ("rotation", "random"):
                d_row, d_col = _deltas(kind, gen, B, P)
                delta = d_row if axis == 2 else d_col
                t = {"fwd": median_ms(lambda: SH._launch_fwd(x, delta, axis)),
                     "bwd": median_ms(lambda: SH._launch_bwd(x, delta, g, axis)),
                     "bwd_nodx": median_ms(lambda: SH._launch_bwd(x, delta, g, axis, False))}
                for k, k_ms in t.items():
                    plan = SH.launch_plan(*SHAPE, axis, k[:3], dtype)
                    b = _shear_bound_ms(SHAPE, axis, x.element_size(), k)
                    c = copy["fwd" if k != "bwd" else "bwd"]
                    cases[f"{k} {name} axis {axis} {kind}"] = {
                        "ms": k_ms, "bound_ms": b, "copy_ms": c,
                        "plan": f"{plan.variant} {plan.tile}"}
                    print(f"shear_{k} {name} {list(SHAPE)} axis {axis} {kind} shifts: "
                          f"{k_ms:.4f} ms, bound {b:.4f} ms, {100 * b / k_ms:.1f} % of bound, "
                          f"copy_ {c:.4f} ms; {plan.variant} tile {plan.tile}, {plan.smem} B, "
                          f"{SH.blocks_per_sm(plan, dtype)} blocks per SM")
        if dtype == torch.float32:  # the line's figures: f32 (the per-shear path), axis 2
            delta = _deltas("rotation", gen, B, P)[0]
            ms = {"fwd": median_ms(lambda: SH._launch_fwd(x, delta, 2)),
                  "bwd": median_ms(lambda: SH._launch_bwd(x, delta, g, 2)),
                  "fwd_plain": median_ms(lambda: SH.fractional_shift_reference(x, delta, 2),
                                         reps=3),
                  "bwd_plain": median_ms(
                      lambda: SH.fractional_shift_vjp_reference(x, delta, g, 2), reps=3)}
    bound = {k: _shear_bound_ms(SHAPE, 2, 4, k) for k in ("fwd", "bwd")}
    for k in ("fwd", "bwd"):
        print(f"shear_{k} float32 {list(SHAPE)} axis 2 rotation shifts: kernel {ms[k]:.4f} ms, "
              f"plain {ms[k + '_plain']:.4f} ms, bound {bound[k]:.4f} ms (bytes)")
    return err, ms, bound, cases


# The decoder stages and STN blocks of the main path (batch 512, patch 128):
# (B, Cin, H, W, Cout) of the four FusedUpConv and the two FusedConvPool calls
# (the localisation runs on the [2B] pair), and edge shapes: n = 2 (every line
# an edge line), C_out = 1, rectangular, one-pixel outputs.
UP_STAGES = [(BATCH, 256, 8, 8, 128), (BATCH, 128, 16, 16, 64), (BATCH, 64, 32, 32, 32),
             (BATCH, 32, 64, 64, 1)]
UP_EDGE = [(3, 8, 2, 2, 4), (3, 4, 5, 7, 1), (2, 6, 2, 9, 3)]
PMAX_BLOCKS = [(2 * BATCH, 1, PATCH, PATCH, 16), (2 * BATCH, 16, PATCH // 2, PATCH // 2, 32)]
PMAX_EDGE = [(3, 1, 4, 4, 1), (3, 3, 4, 12, 4), (2, 2, 2, 2, 3)]
# one rounding of the output's scale: the forwards are built to be bit-equal,
# the backwards' sums of a few terms round once more or less
ULP = {torch.bfloat16: 2.0**-7, torch.float32: 2.0**-20}


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _scale(t) -> float:
    return max(1.0, t.float().abs().max().item())


def _sum_tol(ref, g) -> float:
    """A bias gradient's tolerance: it sums the same cotangents as the plain
    version in another order, in f32 (1e-7 of their absolute sum), then rounds
    once to the I/O type."""
    return ULP[ref.dtype] * _scale(ref) + 1e-7 * g.float().abs().sum().item()


def _upconv_errors(B, C, H, W, relu, dtype, gen):
    """The U kernels against the plain epilogue and autograd through it, on
    random phase maps and projected lines: errors and tolerances."""
    dev = gen.device

    def rnd(*shape, s=1.0):
        return (s * torch.randn(shape, device=dev, generator=gen)).to(dtype)

    y, qr, qc = rnd(B, 4 * C, H, W), rnd(B, 6 * C, 2, W, s=0.3), rnd(B, 6 * C, H, 2, s=0.3)
    bias, g = rnd(1, C), rnd(B, C, 2 * H, 2 * W)
    out = UP._launch_upconv_fwd(y, qr, qc, bias, relu)
    ins = [t.clone().requires_grad_(True) for t in (y, qr, qc, bias)]
    ref = UP.upconv_epilogue_reference(*ins, relu)
    gref = torch.autograd.grad(ref, ins, g)
    gy, gqr, gqc = UP._launch_upconv_bwd(g, out if relu else None)
    ins_k = [t.clone().requires_grad_(True) for t in (y, qr, qc, bias)]
    gk = torch.autograd.grad(UP.UpconvFunction.apply(*ins_k, relu), ins_k, g)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(gk[:3], (gy, gqr, gqc))),
          f"UpconvFunction's backward is not the kernel's at {[B, C, H, W]} {dtype}")
    e = {"fwd": _err(out, ref), "gy": _err(gy, gref[0]), "gqr": _err(gqr, gref[1]),
         "gqc": _err(gqc, gref[2]), "gbias": _err(gk[3], gref[3])}
    u = ULP[dtype]
    # the forward and g_y are held bit-equal (the kernel does the plain
    # version's f32 operations in its order); g_qr and g_qc sum up to six
    # cotangents in another order (one rounding to the I/O type)
    tol = {"fwd": 0.0, "gy": 0.0, "gqr": u * _scale(gref[1]),
           "gqc": u * _scale(gref[2]), "gbias": _sum_tol(gref[3], g)}
    return e, tol


def _pmax_errors(B, C, h, w, dtype, gen, ties: bool):
    """The P kernels against the plain phase max, its routing and autograd
    through it. `ties`: small integers and a zero bias, so that phases tie and
    relu's floor is hit often."""
    dev = gen.device
    if ties:
        y = torch.randint(-2, 3, (B, 4 * C, h, w), device=dev, generator=gen).to(dtype)
        bias = torch.zeros((1, C), device=dev, dtype=dtype)
    else:
        y = torch.randn((B, 4 * C, h, w), device=dev, generator=gen).to(dtype)
        bias = torch.randn((1, C), device=dev, generator=gen).to(dtype)
    g = torch.randn((B, C, h, w), device=dev, generator=gen).to(dtype)
    out, win = UP._launch_pmax_fwd(y, bias)
    ref, win_ref = UP.phase_max_reference(y, bias)
    gy = UP._launch_pmax_bwd(g, win)
    ins = [t.clone().requires_grad_(True) for t in (y, bias)]
    gk = torch.autograd.grad(UP.PhaseMaxFunction.apply(*ins)[0], ins, g)
    ins_r = [t.clone().requires_grad_(True) for t in (y, bias)]
    gr = torch.autograd.grad(UP.phase_max_reference(*ins_r)[0], ins_r, g)
    torch.cuda.synchronize()
    check(torch.equal(gk[0], gy),
          f"PhaseMaxFunction's backward is not the kernel's at {[B, C, h, w]}")
    e = {"fwd": _err(out, ref), "win": int((win != win_ref).sum().item()),
         "gy": _err(gy, UP.phase_max_vjp_reference(g, win_ref)), "gy_autograd": _err(gy, gr[0]),
         "gbias": _err(gk[1], gr[1])}
    tol = {"fwd": 0.0, "win": 0, "gy": 0.0, "gy_autograd": 0.0, "gbias": _sum_tol(gr[1], g)}
    return e, tol


def _old_stage(x, w, b, relu):
    """The decoder stage as the port computed it before: the upsample and pad as
    slices and two-tap sums, then cuDNN's 3x3 convolution."""
    h = F.conv2d(_reflect_pad1(_upsample2x(x)), w, b)
    return F.relu(h) if relu else h


def _old_block(x, k5, b):
    return F.relu(F.max_pool2d(F.conv2d(x, k5, b, padding=2), 2))


def _stage_errors(B, Cin, H, W, C, gen, block: bool):
    """The whole fused stage (or block) through the kernels against the unfused
    chain in f32 with TF32 off: the outputs, then the gradients (x, w, b), all
    within 1e-4 of each one's scale (the convolutions sum in other orders;
    3e-4 for the weights' and bias's long sums). The gradients are taken
    where the two agree on every discrete choice: the stage without its ReLU,
    the block's chain before its ReLU read at the fused block's live winning
    phases (f32 outputs a few ulps apart near 0 or near a tie would else route
    a cotangent to another place)."""
    dev = gen.device
    k = 5 if block else 3
    x = torch.randn((B, Cin, H, W), device=dev, generator=gen)
    w = torch.randn((C, Cin, k, k), device=dev, generator=gen) / math.sqrt(Cin * k * k)
    b = 0.1 * torch.randn((C,), device=dev, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ins_r = [t.clone().requires_grad_(True) for t in (x, w, b)]
    if block:
        y = F.conv2d(UP.space_to_depth2(ins[0]), UP.phase_gather_5to3(ins[1]), padding=1)
        out, win = UP.PhaseMaxFunction.apply(y, ins[2][None])
        errs = [_err(out, _old_block(x, w, b))]
        fine = F.conv2d(ins_r[0], ins_r[1], ins_r[2], padding=2)  # the ReLU is the mask
        fine = fine.view(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5).flatten(-2)
        live = win != 255
        ref = fine.gather(-1, torch.where(live, win, 0).long()[..., None])[..., 0] * live
    else:
        with torch.no_grad():
            errs = [_err(UP.fused_upsample_reflect_conv(x, w, b, relu=True),
                         _old_stage(x, w, b, True)),  # the JAX package's assembly too
                    _err(UP.fused_upsample_reflect_conv_reference(x, w, b),
                         _old_stage(x, w, b, False))]
        out, ref = UP.fused_upsample_reflect_conv(*ins), _old_stage(*ins_r, False)
    g = torch.randn(ref.shape, device=dev, generator=gen)
    got, want = torch.autograd.grad(out, ins, g), torch.autograd.grad(ref, ins_r, g)
    errs += [_err(out, ref)] + [_err(a, c) for a, c in zip(got, want)]
    # dw and db sum up to 8M products in the orders cuDNN's algorithms pick
    # (sqrt(8M) * 2^-24 is 1.7e-4 of their scale): 3e-4 of it
    tols = [1e-4 * _scale(ref)] * (len(errs) - 2) + [3e-4 * _scale(c) for c in want[1:]]
    return errs, tols


def _bytes(kind: str, shape, elem: int, relu: bool = True) -> int:
    """The bytes a kernel must move: each input it reads read once, each output
    written once. upconv_fwd reads half of qr [B, 6C, 2, W] and qc [B, 6C, H, 2]
    (each side's projections on its own pair of lines: B 6C (H + W) entries);
    upconv_bwd reads the saved output only where the stage has a ReLU, and
    writes the whole of g_qr and g_qc (zeros in the unused half, which the edge
    convolutions' backward reads)."""
    B, _, H, W, C = shape
    if kind == "upconv_fwd":  # y, the used half of qr and qc, bias in; out
        return elem * (2 * B * 4 * C * H * W + B * 6 * C * (H + W) + C)
    if kind == "upconv_bwd":  # g, out (the ReLU's mask, if any) in; g_y, g_qr, g_qc
        return elem * ((3 if relu else 2) * B * 4 * C * H * W + B * 12 * C * (H + W))
    h, w = H // 2, W // 2
    if kind == "phasemax_fwd":  # y, bias in; out and the uint8 winner map
        return elem * (B * 4 * C * h * w + C + B * C * h * w) + B * C * h * w
    return elem * (B * C * h * w + B * 4 * C * h * w) + B * C * h * w  # g, win in; g_y


def _launch_count(fn) -> int:
    """Kernels fn launches on the card, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())


def upconv_kernel_phase():
    """Hold the four kernels of ops/csrc/upconv.cu against their plain versions
    at every shape the main path gives them and at edge shapes, in bf16 and in
    f32 (TF32 off); the fused stage and block against the unfused chains in
    f32; then time each kernel at the main path's shapes in bf16 beside its
    plain version, the unfused chain it replaces and the whole fused stage, and
    count one stage's launches both ways."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {k: 0.0 for k in ("upconv_fwd", "upconv_bwd", "phasemax_fwd", "phasemax_bwd")}
    for i, (B, _, H, W, C) in enumerate(UP_STAGES + UP_EDGE):
        for dtype in (torch.bfloat16, torch.float32):
            for r in ((True, False) if i >= len(UP_STAGES) else (i < len(UP_STAGES) - 1,)):
                e, tol = _upconv_errors(B, C, H, W, r, dtype, gen)
                what = f"[{B}, {4 * C}, {H}, {W}] {str(dtype)[6:]} relu {r}"
                print(f"upconv {what}: " + ", ".join(
                    f"{k} {e[k]:.3e} (tol {tol[k]:.1e})" for k in e))
                for k in e:
                    check(e[k] <= tol[k], f"upconv {k} {what}: {e[k]} > {tol[k]}")
                err["upconv_fwd"] = max(err["upconv_fwd"], e["fwd"])
                err["upconv_bwd"] = max(err["upconv_bwd"], e["gy"], e["gqr"], e["gqc"])
    for B, _, H, W, C in PMAX_BLOCKS + PMAX_EDGE:
        for dtype in (torch.bfloat16, torch.float32):
            for ties in (False, True):
                e, tol = _pmax_errors(B, C, H // 2, W // 2, dtype, gen, ties)
                what = f"[{B}, {4 * C}, {H // 2}, {W // 2}] {str(dtype)[6:]} ties {ties}"
                print(f"phasemax {what}: " + ", ".join(f"{k} {e[k]:.3e} (tol {tol[k]:.1e})"
                                                       for k in e))
                for k in e:
                    check(e[k] <= tol[k], f"phasemax {k} {what}: {e[k]} > {tol[k]}")
                err["phasemax_fwd"] = max(err["phasemax_fwd"], e["fwd"])
                err["phasemax_bwd"] = max(err["phasemax_bwd"], e["gy"])
    for shape, block in [(s, False) for s in UP_STAGES + UP_EDGE] + \
                        [(s, True) for s in PMAX_BLOCKS + PMAX_EDGE]:
        errs, tols = _stage_errors(*shape, gen, block)
        names = (["out", "out at the winners"] if block else
                 ["out with ReLU", "JAX assembly", "out"]) + ["dx", "dw", "db"]
        print(f"{'block' if block else 'stage'} {list(shape)} f32 fused vs unfused chain: "
              + ", ".join(f"{n} {a:.3e} (tol {t:.1e})" for n, a, t in zip(names, errs, tols)))
        check(all(a <= t for a, t in zip(errs, tols)), f"fused {shape} disagrees with the chain")

    # times in bf16 at the main path's shapes; the line's figures sum the
    # launches of one decoder pass (four stages) or localisation pass (two blocks)
    torch.backends.cudnn.allow_tf32 = True
    bf = torch.bfloat16
    cases = {k: [] for k in err}
    for i, (B, Cin, H, W, C) in enumerate(UP_STAGES):
        relu = i < len(UP_STAGES) - 1
        x = torch.randn((B, Cin, H, W), device=dev, generator=gen).to(bf)
        w = (torch.randn((C, Cin, 3, 3), device=dev, generator=gen) / math.sqrt(9 * Cin)).to(bf)
        b = (0.1 * torch.randn((C,), device=dev, generator=gen)).to(bf)
        y = F.conv2d(x, UP.phase_kernel(w), padding=1)
        qr = torch.randn((B, 6 * C, 2, W), device=dev, generator=gen).to(bf)
        qc = torch.randn((B, 6 * C, H, 2), device=dev, generator=gen).to(bf)
        bias = b[None]
        out = UP._launch_upconv_fwd(y, qr, qc, bias, relu)
        g = torch.randn(out.shape, device=dev, generator=gen).to(bf)
        ins = [t.clone().requires_grad_(True) for t in (y, qr, qc, bias)]
        ref = UP.upconv_epilogue_reference(*ins, relu)
        xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        old, new = _old_stage(*xs, relu), UP.fused_upsample_reflect_conv(*xs, relu=relu)
        fwd = {"ms": median_ms(lambda: UP._launch_upconv_fwd(y, qr, qc, bias, relu)),
               "plain_ms": median_ms(lambda: UP.upconv_epilogue_reference(y, qr, qc, bias, relu),
                                     reps=3),
               "unfused_ms": median_ms(lambda: _old_stage(x, w, b, relu)),
               "stage_ms": median_ms(lambda: UP.fused_upsample_reflect_conv(x, w, b, relu))}
        bwd = {"ms": median_ms(lambda: UP._launch_upconv_bwd(g, out if relu else None)),
               "plain_ms": median_ms(lambda: torch.autograd.grad(ref, ins, g, retain_graph=True),
                                     reps=3),
               "unfused_ms": median_ms(lambda: torch.autograd.grad(old, xs, g, retain_graph=True)),
               "stage_ms": median_ms(lambda: torch.autograd.grad(new, xs, g, retain_graph=True))}
        for k, d in (("upconv_fwd", fwd), ("upconv_bwd", bwd)):
            d.update(shape=[B, Cin, H, W, C], relu=relu,
                     bound_ms=_bytes(k, (B, Cin, H, W, C), 2, relu) / HBM_BYTES_PER_S * 1e3)
            cases[k].append(d)
            print(f"{k} bf16 stage {i} [{B}, {Cin}, {H}, {W}] -> {C}: kernel {d['ms']:.4f} ms, "
                  f"bound {d['bound_ms']:.4f} ms ({100 * d['bound_ms'] / d['ms']:.1f} %), plain "
                  f"{d['plain_ms']:.4f} ms; the whole stage fused {d['stage_ms']:.4f} ms, "
                  f"unfused {d['unfused_ms']:.4f} ms")
    for i, (B, Cin, H, W, C) in enumerate(PMAX_BLOCKS):
        x = torch.randn((B, Cin, H, W), device=dev, generator=gen).to(bf)
        k5 = (torch.randn((C, Cin, 5, 5), device=dev, generator=gen) / math.sqrt(25 * Cin)).to(bf)
        b = (0.1 * torch.randn((C,), device=dev, generator=gen)).to(bf)
        y = F.conv2d(UP.space_to_depth2(x), UP.phase_gather_5to3(k5), padding=1)
        bias = b[None]
        out, win = UP._launch_pmax_fwd(y, bias)
        g = torch.randn(out.shape, device=dev, generator=gen).to(bf)
        ins = [t.clone().requires_grad_(True) for t in (y, bias)]
        ref = UP.phase_max_reference(*ins)[0]
        # the main path's first block sees data (no input gradient), the second a map
        xs = [t.clone().requires_grad_(i > 0 or j > 0) for j, t in enumerate((x, k5, b))]
        need = [t for t in xs if t.requires_grad]
        old, new = _old_block(*xs), UP.fused_conv5_relu_maxpool(*xs)
        fwd = {"ms": median_ms(lambda: UP._launch_pmax_fwd(y, bias)),
               "plain_ms": median_ms(lambda: UP.phase_max_reference(y, bias), reps=3),
               "unfused_ms": median_ms(lambda: _old_block(x, k5, b)),
               "stage_ms": median_ms(lambda: UP.fused_conv5_relu_maxpool(x, k5, b))}
        bwd = {"ms": median_ms(lambda: UP._launch_pmax_bwd(g, win)),
               "plain_ms": median_ms(lambda: torch.autograd.grad(ref, ins, g, retain_graph=True),
                                     reps=3),
               "unfused_ms": median_ms(lambda: torch.autograd.grad(old, need, g,
                                                                   retain_graph=True)),
               "stage_ms": median_ms(lambda: torch.autograd.grad(new, need, g,
                                                                 retain_graph=True))}
        for k, d in (("phasemax_fwd", fwd), ("phasemax_bwd", bwd)):
            d.update(shape=[B, Cin, H, W, C], bound_ms=_bytes(k, (B, Cin, H, W, C), 2)
                     / HBM_BYTES_PER_S * 1e3)
            cases[k].append(d)
            print(f"{k} bf16 block {i} [{B}, {Cin}, {H}, {W}] -> {C}: kernel {d['ms']:.4f} ms, "
                  f"bound {d['bound_ms']:.4f} ms ({100 * d['bound_ms'] / d['ms']:.1f} %), plain "
                  f"{d['plain_ms']:.4f} ms; the whole block fused {d['stage_ms']:.4f} ms, "
                  f"unfused {d['unfused_ms']:.4f} ms")

    # one decoder stage's (stage 1) and STN block's (block 1) launches, both ways
    B, Cin, H, W, C = UP_STAGES[1]
    x = torch.randn((B, Cin, H, W), device=dev, generator=gen).to(bf).requires_grad_(True)
    w = (0.05 * torch.randn((C, Cin, 3, 3), device=dev, generator=gen)).requires_grad_(True)
    b = torch.zeros((C,), device=dev, requires_grad=True)
    B2, Cin2, H2, W2, C2 = PMAX_BLOCKS[1]
    x2 = torch.randn((B2, Cin2, H2, W2), device=dev, generator=gen).to(bf).requires_grad_(True)
    k2 = (0.05 * torch.randn((C2, Cin2, 5, 5), device=dev, generator=gen)).requires_grad_(True)
    b2 = torch.zeros((C2,), device=dev, requires_grad=True)

    def stage(fused, backward):  # as the model runs it: the weights cast to bf16 first
        def run():
            wc, bc = w.to(bf), b.to(bf)
            out = (UP.fused_upsample_reflect_conv(x, wc, bc, relu=True) if fused else
                   _old_stage(x, wc, bc, True))
            if backward:
                out.float().sum().backward()
        return run

    def block(fused, backward):
        def run():
            kc, bc = k2.to(bf), b2.to(bf)
            out = UP.fused_conv5_relu_maxpool(x2, kc, bc) if fused else _old_block(x2, kc, bc)
            if backward:
                out.float().sum().backward()
        return run

    launches = {f"{what}_{way}_{d}": _launch_count(fn(way == "fused", d == "fwd_bwd"))
                for what, fn in (("stage", stage), ("block", block))
                for way in ("unfused", "fused") for d in ("fwd", "fwd_bwd")}
    print("launches of one decoder stage (stage 1) and STN block (block 1), bf16: "
          + json.dumps(launches))
    check(launches["stage_fused_fwd"] < launches["stage_unfused_fwd"],
          f"the fused stage's forward launches {launches['stage_fused_fwd']} kernels, the "
          f"unfused {launches['stage_unfused_fwd']}")
    ms = {k: sum(c["ms"] for c in v) for k, v in cases.items()}
    return {"err": err, "ms": ms, "cases": cases,
            "launches_per_call": launches}


def agreement_phase():
    """f32 model on the card vs the same weights on the CPU, small batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = RVAE(LATENT, 1, PATCH, device="cuda", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = torch.rand((8, 1, PATCH, PATCH), generator=g)
    x_rot = torch.rand((8, 1, PATCH, PATCH), generator=g)
    eps = torch.randn((8, LATENT), generator=g)
    with torch.no_grad():
        want = cpu.train_forward_paired(x, x_rot, eps=eps)
        got = gpu.train_forward_paired(x.cuda(), x_rot.cuda(), eps=eps.cuda())
    torch.cuda.synchronize()
    worst = max((a.float().cpu() - b.float()).abs().max().item() for a, b in zip(got, want))
    # 2e-4: the bound the CPU port holds against the JAX package
    print(f"agreement: f32 train_forward_paired, card vs CPU, max_abs_err {worst:.3e} (tol 2e-4)")
    check(worst <= 2e-4, "model on the card disagrees with the CPU")


def bench_dataset():
    """(dataset, build seconds) of the bench frame, as bench.py builds it."""
    t0 = time.perf_counter()
    frame, _ = synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)
    ds = PairedAdaptiveLatticeDataset([frame], patch_size=PATCH, padding=PADDING, device="cuda")
    build_s = time.perf_counter() - t0
    check(len(ds) == 1409, f"site table has {len(ds)} sites, the bench frame gives 1409")
    return ds, build_s


def main_path(ds, build_s: float):
    # Main path: the convolutions run in bfloat16 (TF32 does not apply); the
    # float32 dense layers run in full float32 (matmul TF32 off, the default).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    n = len(ds)
    model = RVAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
                 generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    frames_padded, img_idx, coords, margin = ds.device_site_table
    kw = dict(patch_size=PATCH, padding=PADDING, margin=margin)
    step = make_fused_rvae_train_step(model, opt, cfg=ds.transform, canonical_weight=0.2,
                                      grad_max_norm=20.0, **kw)
    evaluate = make_fused_rvae_eval(model, cfg=ds.transform, canonical_weight=0.2, **kw)
    encode = make_fused_encode(model, **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    epochs = []
    for e in range(EPOCHS):
        idx = torch.randint(0, n, (STEPS_PER_EPOCH, BATCH), generator=gen, device="cuda")
        vidx = torch.randint(0, n, (VAL_BATCHES, BATCH), generator=gen, device="cuda")
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tm = metrics_to_host(step(frames_padded, img_idx, coords, idx, gen, 10.0, 10.0))
        t1 = time.perf_counter()
        c1 = counts()
        vm = metrics_to_host(evaluate(frames_padded, img_idx, coords, vidx, gen, 10.0, 10.0))
        t2 = time.perf_counter()
        c2 = counts()
        got = {k: c1[k] - c0[k] for k in c0}
        check(got == launches_of((PAIRED_STEP, STEPS_PER_EPOCH)),
              f"train launches {got} for {STEPS_PER_EPOCH} steps")
        got = {k: c2[k] - c1[k] for k in c0}
        check(got == launches_of((PAIRED_EVAL, VAL_BATCHES)), f"eval launches {got}")
        for name, v in list(tm.items()) + list(vm.items()):
            check(bool(np.isfinite(v).all()), f"epoch {e} metric {name} not finite")
        epochs.append(dict(train_s=t1 - t0, eval_s=t2 - t1,
                           train_loss=float(tm["loss"]), val_loss=float(vm["loss"].mean())))
        print(f"epoch {e}: train {t1 - t0:.3f} s ({STEPS_PER_EPOCH} steps), eval {t2 - t1:.3f} s,"
              f" train loss {float(tm['loss']):.4f}, val loss {float(vm['loss'].mean()):.4f}")

    eidx = torch.randint(0, n, (ENCODE_STEPS, BATCH), generator=gen, device="cuda")
    encode(frames_padded, img_idx, coords, eidx)  # first call: cuDNN plans for the encode shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, logvar, theta = encode(frames_padded, img_idx, coords, eidx)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    launches = counts()
    m = ENCODE_STEPS * BATCH
    check(tuple(mu.shape) == (m, LATENT) and tuple(logvar.shape) == (m, LATENT)
          and tuple(theta.shape) == (m, 1), "encode shapes")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(logvar).all()
               and torch.isfinite(theta).all()), "encode outputs not finite")
    steps = EPOCHS * STEPS_PER_EPOCH
    check(launches == launches_of((PAIRED_STEP, steps), (PAIRED_EVAL, EPOCHS * VAL_BATCHES),
                                  (ENCODE_BATCH, 2 * ENCODE_STEPS)),
          f"main path launches {launches}")

    last = epochs[-1]
    result = {
        "dataset_build_s": build_s,
        "sites": n,
        "train_patches_per_s": STEPS_PER_EPOCH * BATCH / last["train_s"],
        "epoch_patches_per_s": STEPS_PER_EPOCH * BATCH / (last["train_s"] + last["eval_s"]),
        "encode_patches_per_s": m / encode_s,
        "epochs": epochs,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }
    return result


def rotation_path_phase():
    """The per-shear rotation path against the fused rot3, and a multi-channel
    rotation under "auto"; returns the launches of both."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S = 512, PATCH
    margin = aligned_margin(S)  # canvas 256
    launches = {k: 0 for k in counts()}
    for dtype in (torch.float32, torch.bfloat16):
        img = torch.rand((B, 1, S, S), device=dev, generator=gen).to(dtype)
        th = (torch.rand(B, device=dev, generator=gen) * 2 - 1) * torch.pi
        out, grad = {}, {}
        for backend in ("fused", "shear"):
            t = th.clone().requires_grad_(True)
            zero_counts()
            out[backend] = rotate_image_fast(img, t, "reflection", margin=margin, backend=backend)
            grad[backend] = torch.autograd.grad(out[backend].float().square().sum(), t)[0]
            torch.cuda.synchronize()
            got = counts()
            want = ({**NO_LAUNCH, "rot3_fwd": 1, "rot3_bwd": 1} if backend == "fused" else
                    {**NO_LAUNCH, "shear_fwd": 3, "shear_bwd": 3})
            check(got == want, f"rotate_image_fast({backend}) {dtype} launches {got}")
            for k in launches:
                launches[k] += got[k]
        fe = (out["shear"].float() - out["fused"].float()).abs().max().item()
        ge = (grad["shear"] - grad["fused"]).abs().max().item()
        scale = grad["fused"].abs().max().item()
        # the same f32 lerps and one cast: bit-equal. d theta: the two backwards
        # sum the delta cotangents over the canvas in other orders.
        tol_g = 1e-3 * max(1.0, scale)
        print(f"rotation {str(dtype)[6:]:8s} [{B}, 1, {S}, {S}] canvas {S + 2 * margin}: shear vs "
              f"fused max_abs_err {fe:.3e} (tol 0), d theta {ge:.3e} (tol {tol_g:.1e})")
        check(fe == 0.0, f"per-shear rotation differs from the fused rot3 in {dtype}")
        check(ge <= tol_g, f"per-shear rotation d theta differs from the fused rot3 in {dtype}")
        if dtype == torch.float32:  # times of both backends (not counted as the path's run)
            for backend in ("fused", "shear"):
                t = th.clone().requires_grad_(True)
                fwd = median_ms(lambda: rotate_image_fast(img, th, "reflection", margin=margin,
                                                          backend=backend))
                both = median_ms(lambda: torch.autograd.grad(rotate_image_fast(
                    img, t, "reflection", margin=margin, backend=backend).square().sum(), t))
                print(f"rotation f32 [{B}, 1, {S}, {S}] canvas {S + 2 * margin} {backend}: "
                      f"forward {fwd:.4f} ms, forward+backward (d theta) {both:.4f} ms")

    # three channels take the per-shear path under "auto"; the result agrees with
    # the CPU port (which the tests hold against the JAX package) up to the last
    # ulp of tan / sin in the shifts, times shifts of up to about 50 pixels
    img = torch.rand((64, 3, S, S), device=dev, generator=gen)
    th = (torch.rand(64, device=dev, generator=gen) * 2 - 1) * torch.pi
    zero_counts()
    out = rotate_image_fast(img, th, "reflection")
    torch.cuda.synchronize()
    got = counts()
    check(got["shear_fwd"] == 3 and got["rot3_fwd"] == 0 and got["rot3_bwd"] == 0,
          f"3-channel auto rotation launches {got}")
    for k in launches:
        launches[k] += got[k]
    want = rotate_image_fast(img.cpu(), th.cpu(), "reflection")
    e = (out.cpu() - want).abs().max().item()
    print(f"rotation f32 [64, 3, {S}, {S}] auto: card vs CPU max_abs_err {e:.3e} (tol 1e-4)")
    check(tuple(out.shape) == (64, 3, S, S) and e <= 1e-4, "3-channel rotation")
    return launches


def exact_train_phase(ds):
    """Fused paired training of RVAE(fast_resample=False), bf16, batch 512."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    model = RVAE(LATENT, 1, PATCH, "bfloat16", fast_resample=False, device="cuda",
                 generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    frames_padded, img_idx, coords, margin = ds.device_site_table
    step = make_fused_rvae_train_step(model, opt, cfg=ds.transform, canonical_weight=0.2,
                                      grad_max_norm=20.0, patch_size=PATCH, padding=PADDING,
                                      margin=margin)
    gen = torch.Generator(device="cuda").manual_seed(5)
    warm = torch.randint(0, len(ds), (1, BATCH), generator=gen, device="cuda")
    metrics_to_host(step(frames_padded, img_idx, coords, warm, gen, 10.0, 10.0))
    idx = torch.randint(0, len(ds), (EXACT_STEPS, BATCH), generator=gen, device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    tm = metrics_to_host(step(frames_padded, img_idx, coords, idx, gen, 10.0, 10.0))
    dt = time.perf_counter() - t0
    got = counts()
    # the extraction's rotation only; the decoder and the localisation as ever
    check(got == launches_of((rvae(1, 1, 1, 1, rot3_fwd=1), EXACT_STEPS)),
          f"exact-resample train launches {got}")
    for name, v in tm.items():
        check(bool(np.isfinite(v).all()), f"exact-resample metric {name} not finite")
    result = {"train_patches_per_s": EXACT_STEPS * BATCH / dt, "steps": EXACT_STEPS,
              "loss": float(tm["loss"]), "launches": got}
    print(f"exact-resample train: {EXACT_STEPS} steps in {dt:.3f} s, "
          f"{result['train_patches_per_s']:.1f} patches/s, loss {result['loss']:.4f}")
    return result


def bench_phase():
    """python -m livae_tpu_torch.bench_rotate --reps 3, at its default shapes."""
    zero_counts()
    results = bench_rotate.main(["--reps", "3"])
    torch.cuda.synchronize()
    got = counts()
    reps = 3 + 1  # the warm-up call
    check(got["shear_fwd"] == 2 * 2 * reps and got["shear_bwd"] == 0,
          f"bench_rotate shear launches {got}")
    check(got["rot3_fwd"] == 2 * 2 * 2 * reps and got["rot3_bwd"] == 2 * 2 * reps,
          f"bench_rotate rot3 launches {got}")
    check(all(np.isfinite(v) and v > 0 for v in results.values()), "bench_rotate times")
    return results, got


def _quiet(fn, *args, **kwargs):
    """fn(*args, **kwargs) with what it prints passed through once it returns
    (or fails); returns (result, what it printed)."""
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            out = fn(*args, **kwargs)
    finally:
        sys.stdout.write(printed.getvalue())
    return out, printed.getvalue()


def run_cli(script, argv):
    """`script.run_training(args)` in-process on parsed arguments, with the
    launch counters zeroed just before and read just after. Returns (result,
    launches, what it printed, peak GiB allocated)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = script.build_argparser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out, printed = _quiet(script.run_training, args)
    torch.cuda.synchronize()
    return out, counts(), printed, torch.cuda.max_memory_allocated() / 2**30


def _epoch_rates(out, batch: int = BATCH):
    """Per epoch: patches/s of the train steps alone, and with the eval."""
    return [{"epoch": e["epoch"], "steps": e["steps"], "val_batches": e["val_batches"],
             "train_patches_per_s": e["steps"] * batch / e["train_s"],
             "epoch_patches_per_s": e["steps"] * batch / (e["train_s"] + e["eval_s"])}
            for e in out["epochs"]]


def _check_epochs(out, what: str, per_step, per_val_batch):
    """Every epoch of a run: finite metrics, and the kernel launches that its
    steps and val batches (the ragged tail too) must make."""
    n, n_train, n_val = out["sites"]
    for e in out["epochs"]:
        check(e["steps"] == n_train // BATCH and e["steps"] >= 2,
              f"{what} epoch {e['epoch']} took {e['steps']} steps for {n_train} train sites")
        check(e["val_batches"] == -(-n_val // BATCH), f"{what} val batches {e['val_batches']}")
        want = dict(NO_LAUNCH)
        for k, v in per_step.items():
            want[k] += v * e["steps"]
        for k, v in per_val_batch.items():
            want[k] += v * e["val_batches"]
        check(e["launches"] == want,
              f"{what} epoch {e['epoch']} launches {e['launches']}, expected {want}")
        for name, v in e["metrics"].items():
            check(math.isfinite(v), f"{what} epoch {e['epoch']} metric {name} = {v}")


def train_rvae_phase(tmp: Path):
    """train_rvae end to end: 3 epochs, then a resumed fourth."""
    ckpt = tmp / "rvae" / "rvae_best.pt"
    argv = [*CLI_DATA, "--stn-lr", "1e-4", "--beta-annealing", "--beta-warmup-epochs", "1",
            "--beta-annealing-epochs", "2", "--checkpoint-every", "1", "--checkpoint", str(ckpt)]
    os.environ["LIVAE_PARAM_HASH"] = "1"
    try:
        out, launches, _, peak = run_cli(train_rvae, [*argv, "--epochs", "3"])
        n, n_train, n_val = out["sites"]
        check(n_val > BATCH and n_val % BATCH != 0,
              f"{n_val} val sites give no full batch with a ragged tail")
        canvas = PATCH + 2 * PADDING
        canvas += 2 * (canvas // 6)
        check((canvas,) * 2 == SHAPE[1:] and (n_val % BATCH, canvas, canvas) in PATH_SHAPES,
              f"the kernel phase did not hold rot3 at the tail's {[n_val % BATCH, canvas, canvas]}")
        paired = dict(per_step=PAIRED_STEP, per_val_batch=PAIRED_EVAL)
        _check_epochs(out, "train_rvae", **paired)
        check(len(out["epochs"]) == 3 and [e["beta"] for e in out["epochs"]] == [0.0, 0.0, 5.0],
              f"train_rvae betas {[e['beta'] for e in out['epochs']]}")
        check(launches == {k: sum(e["launches"][k] for e in out["epochs"]) for k in launches},
              f"train_rvae launched {launches} outside its epochs' counts")
        # the optimizer's two rates (model, STN) against the cosine schedules, at each
        # epoch's first step and, from the schedule, at the last step taken
        steps = out["epochs"][0]["steps"]
        total = 3 * steps

        def cosine(count):
            return [lr * 0.5 * (1.0 + math.cos(math.pi * count / total)) for lr in (1e-3, 1e-4)]

        for e in out["epochs"]:
            got, want = e["lr_first_step"], cosine(e["epoch"] * steps)
            check(len(got) == 2 and all(math.isclose(a, b, rel_tol=1e-9) for a, b in zip(got, want)),
                  f"train_rvae epoch {e['epoch']} rates {got}, the schedules give {want}")
        got, want = out["epochs"][-1]["lr_last_step"], cosine(total - 1)
        check(all(math.isclose(a, b, rel_tol=1e-9) for a, b in zip(got, want)),
              f"train_rvae last step's rates {got}, the schedules give {want}")
        check(out["scheduler"].last_epoch == total,
              f"schedule count {out['scheduler'].last_epoch}")

        final = Path(out["final_checkpoint"])
        check(ckpt.exists() and final.exists() and final.name == "rvae_best_final.pt",
              "train_rvae wrote no best or _final checkpoint")
        for path in (ckpt, final):
            payload = load_checkpoint(path)
            check(set(payload) == {"model_state", "optimizer_state", "epoch", "best_val", "args"},
                  f"{path.name} holds {sorted(payload)}")
            check(payload["args"]["patch_size"] == PATCH and payload["args"]["stn_lr"] == 1e-4,
                  f"{path.name} does not carry the run's arguments")
        state, payload = load_reference_checkpoint(final)
        check(payload["epoch"] == 2 and payload["best_val"] == out["best_val"], "_final's payload")
        fresh = RVAE(LATENT, 1, PATCH, "bfloat16", device="cuda")
        fresh.load_state_dict(state, strict=True)
        x = torch.rand((64, 1, PATCH, PATCH), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(6))
        with torch.no_grad():
            same = all(torch.equal(a, b) for a, b in zip(fresh.encode(x), out["model"].encode(x)))
        check(same, "a model loaded from _final encodes differently from the trained one")

        resumed, r_launches, printed, r_peak = run_cli(train_rvae, [*argv, "--epochs", "4",
                                                                    "--resume"])
        check("Resumed from" in printed and "at epoch 3" in printed, "no 'Resumed from' line")
        check(resumed["start_epoch"] == 3 and [e["epoch"] for e in resumed["epochs"]] == [3],
              f"resumed run ran epochs {[e['epoch'] for e in resumed['epochs']]}")
        check(resumed["resumed_digest"] is not None
              and resumed["resumed_digest"] == out["epochs"][2]["digest"],
              f"restored digest {resumed['resumed_digest']}, epoch 2 printed "
              f"{out['epochs'][2]['digest']}")
        check(resumed["sites"] == out["sites"], "the resumed run built another site table")
        _check_epochs(resumed, "train_rvae --resume", **paired)
        check(resumed["epochs"][0]["beta"] == 10.0, f"resumed beta {resumed['epochs'][0]['beta']}")
        check(r_launches == resumed["epochs"][0]["launches"], f"resumed launches {r_launches}")
    finally:
        del os.environ["LIVAE_PARAM_HASH"]
    return {
        "sites": list(out["sites"]), "dataset_build_s": out["dataset_build_s"],
        "epochs": _epoch_rates(out), "resumed_epoch": _epoch_rates(resumed)[0],
        "betas": [e["beta"] for e in out["epochs"]] + [resumed["epochs"][0]["beta"]],
        "train_loss": [e["metrics"]["train_loss"] for e in out["epochs"] + resumed["epochs"]],
        "val_loss": [e["metrics"]["val_loss"] for e in out["epochs"] + resumed["epochs"]],
        "peak_memory_gib": max(peak, r_peak),
        "launches": {k: launches[k] + r_launches[k] for k in launches},
    }


def train_vae_phase(tmp: Path):
    """train_vae end to end on the same data: 3 epochs at the defaults."""
    ckpt = tmp / "vae" / "vae_best.pt"
    out, launches, _, peak = run_cli(train_vae, [*CLI_DATA, "--epochs", "3",
                                                 "--checkpoint", str(ckpt)])
    _check_epochs(out, "train_vae", per_step={}, per_val_batch={})
    check(launches == NO_LAUNCH, f"train_vae launched {launches}")
    check(len(out["epochs"]) == 3 and all(e["beta"] == 1.0 for e in out["epochs"]),
          "train_vae epochs")
    final = Path(out["final_checkpoint"])
    check(ckpt.exists() and final.exists(), "train_vae wrote no best or _final checkpoint")
    for path in (ckpt, final):
        state, payload = load_reference_checkpoint(path)
        check(set(payload) == {"model_state", "optimizer_state", "epoch", "best_val", "args"},
              f"{path.name} holds {sorted(payload)}")
        VAE(LATENT, 1, PATCH, "bfloat16", device="cuda").load_state_dict(state, strict=True)
    return {
        "sites": list(out["sites"]), "dataset_build_s": out["dataset_build_s"],
        "epochs": _epoch_rates(out),
        "train_loss": [e["metrics"]["train_loss"] for e in out["epochs"]],
        "val_loss": [e["metrics"]["val_loss"] for e in out["epochs"]],
        "peak_memory_gib": peak, "launches": launches,
    }


def patch_dataset_phase():
    """Fused VAE steps on PatchDataset, whose augmentation rotates each batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    frame, _ = synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)
    ds = PatchDataset([frame], patch_size=PATCH, device="cuda")
    build_s = time.perf_counter() - t0
    check(len(ds) > 0 and ds.transform.rotation and not ds._NORMALIZE, "PatchDataset set-up")
    canvas = PATCH + 2 * ds.padding
    canvas += 2 * (canvas // 6)
    check((BATCH, canvas, canvas) in PATH_SHAPES,
          f"the kernel phase did not hold rot3 at PatchDataset's {[BATCH, canvas, canvas]}")
    model = VAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
                generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model, 1e-3, optimizer="adam")
    frames_padded, img_idx, coords, margin = ds.device_site_table
    step = make_fused_vae_train_step(model, opt, patch_size=PATCH, padding=ds.padding,
                                     cfg=ds.transform, margin=margin, normalize=False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    warm = torch.randint(0, len(ds), (1, BATCH), generator=gen, device="cuda")
    metrics_to_host(step(frames_padded, img_idx, coords, warm, gen, 1.0, 0.0))
    idx = torch.randint(0, len(ds), (PATCH_DATASET_STEPS, BATCH), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    tm = metrics_to_host(step(frames_padded, img_idx, coords, idx, gen, 1.0, 0.0))
    dt = time.perf_counter() - t0
    got = counts()
    check(got == {**NO_LAUNCH, "rot3_fwd": PATCH_DATASET_STEPS},
          f"PatchDataset train launches {got}")
    for name, v in tm.items():
        check(bool(np.isfinite(v).all()), f"PatchDataset metric {name} not finite")
    return {"sites": len(ds), "dataset_build_s": build_s, "steps": PATCH_DATASET_STEPS,
            "train_patches_per_s": PATCH_DATASET_STEPS * BATCH / dt, "loss": float(tm["loss"]),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": got}


def vae_agreement_phase():
    """f32 VAE on the card vs the same weights on the CPU, small batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = VAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = VAE(LATENT, 1, PATCH, device="cuda", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = torch.rand((8, 1, PATCH, PATCH), generator=g)
    eps = torch.randn((8, LATENT), generator=g)
    with torch.no_grad():
        want = cpu(x, eps=eps)
        got = gpu(x.cuda(), eps=eps.cuda())
    torch.cuda.synchronize()
    worst = max((a.float().cpu() - b.float()).abs().max().item() for a, b in zip(got, want))
    # 2e-4: the bound the CPU port holds against the JAX package
    print(f"agreement: f32 VAE forward, card vs CPU, max_abs_err {worst:.3e} (tol 2e-4)")
    check(worst <= 2e-4, "VAE on the card disagrees with the CPU")


def _missing(*modules) -> list[str]:
    """The modules of `modules` that cannot be imported here, each with why."""
    missing = []
    for name in modules:
        try:
            __import__(name)
        except ImportError as e:
            missing.append(f"{name} ({e})")
    return missing


def analysis_phase(tmp: Path, final: Path):
    """The analysis scripts on train_rvae's _final checkpoint and the two
    frames, at their defaults (padding 16, batch 256, float32): every site
    encoded by `collect_stats` twice (the first call finds cuDNN's plans),
    then `verify_rotational_invariance` on 32 probes, with the launches of the
    three counted; then the t-SNE embedding, the KMeans cluster maps and the
    scripts' plots where sklearn and matplotlib are importable."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as a user runs it
    argv = [*FRAMES, "--checkpoint", str(final), "--plots-dir", str(tmp / "plots")]
    args = visualizations.build_argparser().parse_args(argv)
    t0 = time.perf_counter()
    (model, is_rvae, ds), _ = _quiet(visualizations.load_for_analysis, args, None)
    load_s = time.perf_counter() - t0
    check(is_rvae and model.patch_size == PATCH and model.latent_dim == LATENT,
          "the analysis did not load train_rvae's rVAE")
    n = len(ds)
    nb = -(-n // ANALYSIS_BATCH)
    for b in {ANALYSIS_BATCH, n % ANALYSIS_BATCH or ANALYSIS_BATCH}:
        check((b, *SHAPE[1:]) in PATH_SHAPES,
              f"the kernel phase did not hold rot3 at the analysis's {[b, *SHAPE[1:]]}")

    torch.cuda.synchronize()
    zero_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        mu, logvar, rec_err, idx_map = visualizations.collect_stats(model, ds, ANALYSIS_BATCH,
                                                                    is_rvae)
        times.append(time.perf_counter() - t0)  # ends in the read of the results
    results, printed = _quiet(verify_rotational_invariance.main,
                              [*FRAMES, "--checkpoint", str(final)])
    torch.cuda.synchronize()
    launches = counts()
    # per batch a forward: 2 rot3 forwards (the STN's rotation and the inverse
    # rotation), a decoder and a localisation pass; check_invariance: 3 rot3
    # forwards (the rot90 of the probes and two encodes) and two localisations
    want = launches_of((rvae(1, 0, 1, 0, rot3_fwd=2), 2 * nb), (rvae(0, 0, 2, 0, rot3_fwd=3), 1))
    check(launches == want, f"analysis launches {launches}, expected {want}")
    check(mu.shape == (n, LATENT) and logvar.shape == (n, LATENT) and rec_err.shape == (n,)
          and len(idx_map) == n, "collect_stats shapes")
    check(bool(np.isfinite(mu).all() and np.isfinite(logvar).all()
               and np.isfinite(rec_err).all()), "collect_stats outputs not finite")
    last = len(ds.sample_coords) - 1
    check(idx_map[0] == (0, 0) and idx_map[-1] == (last, len(ds.sample_coords[last]) - 1),
          "collect_stats index map")
    inv = results[0]
    check(math.isfinite(inv["cosine_similarity"]) and "rotation-invariant" in inv["verdict"],
          f"check_invariance {inv}")

    # the same sites through make_fused_encode (the fused encode of the train path)
    frames_padded, img_idx, coords, margin = ds.device_site_table
    encode = make_fused_encode(model, patch_size=PATCH, padding=args.padding, margin=margin,
                               normalize=ds.normalize, device=ds.device)
    sites = torch.arange(n, device="cuda")
    full = (n // ANALYSIS_BATCH) * ANALYSIS_BATCH
    mu_enc = torch.cat([
        encode(frames_padded, img_idx, coords, sites[:full].reshape(-1, ANALYSIS_BATCH))[0],
        encode(frames_padded, img_idx, coords, sites[full:].reshape(1, -1))[0],
    ]).cpu().numpy()
    e_enc = float(np.abs(mu_enc - mu).max())
    print(f"analysis: collect_stats mu vs make_fused_encode mu, max_abs_err {e_enc:.3e} "
          f"(tol 2e-4)")
    check(e_enc <= 2e-4, "collect_stats and make_fused_encode disagree")

    # one batch with the noise injected, card against the CPU port, in full f32
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = visualizations.load_model_from_checkpoint(str(final), None, "cpu")[0]
    x = ds.batch_at(np.arange(ROTATION_PROBES))
    eps = torch.randn((ROTATION_PROBES, LATENT), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got = visualizations._batch_stats(model, x, True, eps.cuda())
        want_cpu = visualizations._batch_stats(cpu_model, x.cpu(), True, eps)
    e_cpu = {name: (g.cpu() - w).abs().max().item()
             for name, g, w in zip(("mu", "logvar", "rec_err"), got, want_cpu)}
    torch.backends.cudnn.allow_tf32 = True
    print(f"analysis: one batch of {ROTATION_PROBES}, card vs CPU with eps injected, max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in e_cpu.items()) + " (tol 2e-4)")
    check(all(v <= 2e-4 for v in e_cpu.values()), "analysis batch disagrees with the CPU")

    steps = {}
    missing = _missing("sklearn")
    if missing:
        print(f"analysis: skipped embed_latents (t-SNE, PCA) and the KMeans clustering: "
              f"{', '.join(missing)} is not importable here")
    else:
        t0 = time.perf_counter()
        emb = visualizations.embed_latents(mu)
        steps["embed_latents_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels = visualizations.cluster_labels(mu, 3)
        steps["kmeans_s"] = time.perf_counter() - t0
        check(emb.shape == (n, 2) and np.isfinite(emb).all() and labels.shape == (n,),
              "embedding or cluster labels")
        print(f"analysis: t-SNE of {n} latents {steps['embed_latents_s']:.2f} s, "
              f"KMeans {steps['kmeans_s']:.2f} s")
    missing = _missing("sklearn", "matplotlib")
    if missing:
        print(f"analysis: skipped the plots of visualizations and plot_tsne_by_image "
              f"(embedding, cluster maps, windows, atom clusters): {', '.join(missing)} "
              f"not importable here")
    else:
        tsne_png = tmp / "plots" / "embedding_by_image3.png"
        t0 = time.perf_counter()
        _quiet(visualizations.main, argv)
        _quiet(plot_tsne_by_image.main, [*FRAMES, "--checkpoint", str(final),
                                         "--out", str(tsne_png)])
        steps["scripts_s"] = time.perf_counter() - t0
        plots = tmp / "plots"
        want_files = [plots / "latent_embeddings.png", tsne_png] + [
            plots / d / f"image_{i}_{d}.png" for d in ("clusters", "atom_clusters")
            for i in range(len(ds.sample_coords))] + [plots / "windows" / f"latent_hist_scatter_ws{w}.png"
                                for w in (10, 20, 30, 60, 90, 120)]
        check(all(f.exists() and f.stat().st_size > 0 for f in want_files),
              "the analysis scripts did not write their plots")
        print(f"analysis: visualizations and plot_tsne_by_image wrote {len(want_files)} plots "
              f"in {steps['scripts_s']:.2f} s")

    result = {"sites": n, "batches": nb, "load_s": load_s,
              "encode_s": times, "encode_patches_per_s": [n / t for t in times],
              "invariance": inv, "mu_vs_fused_encode": e_enc, "card_vs_cpu": e_cpu,
              "steps": steps, "launches": launches}
    print(f"analysis: collect_stats of {n} sites {times[1]:.3f} s, "
          f"{n / times[1]:.1f} patches/s (first call {n / times[0]:.1f}); "
          f"check_invariance cos {inv['cosine_similarity']:.4f} -> {inv['verdict']}")
    return result, ds


def rotation_invariance_phase(final: Path, ds):
    """evaluate_rotation_invariance on 64 probes of the analysis's sites, eight
    angles, with the noise injected; against the same weights on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # full f32 for the comparison with the CPU
    model = visualizations.load_model_from_checkpoint(str(final), None, "cuda")[0]
    cpu_model = visualizations.load_model_from_checkpoint(str(final), None, "cpu")[0]
    probes = ds.batch_at(np.linspace(0, len(ds) - 1, ROTATION_PROBES).astype(int))
    g = torch.Generator().manual_seed(9)
    eps = [torch.randn((ROTATION_PROBES, LATENT), generator=g) for _ in range(8)]
    evaluate_rotation_invariance(model, probes, eps=[e.cuda() for e in eps])  # cuDNN's plans
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got = evaluate_rotation_invariance(model, probes, eps=[e.cuda() for e in eps])
    dt = time.perf_counter() - t0  # ends in the host read of the metrics
    launches = counts()
    # per angle: the probes' rotation, the STN's and the inverse rotation, the
    # rotation back; a forward (a decoder and a localisation pass)
    want_launches = launches_of((rvae(1, 0, 1, 0, rot3_fwd=4), 8))
    check(launches == want_launches, f"rotation invariance launches {launches}")
    want = evaluate_rotation_invariance(cpu_model, probes.cpu(), eps=eps)
    # 2e-4 absolute for each metric, as for the model: the angle error wraps
    # theta's difference through sin and cos, so a theta that lands on the other
    # side of +-pi on one device moves it by no more than its own rounding
    err = {k: abs(got[k] - want[k]) for k in want}
    print(f"rotation_invariance: {ROTATION_PROBES} probes x 8 angles in {dt:.3f} s; "
          + ", ".join(f"{k} {got[k]:.6f}" for k in got)
          + "; card vs CPU max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + " (tol 2e-4)")
    check(set(got) == {"latent_variance", "recon_rmse", "recon_psnr", "recon_ssim", "angle_error"}
          and all(math.isfinite(v) for v in got.values()), f"rotation invariance {got}")
    check(all(v <= 2e-4 for v in err.values()), "rotation invariance disagrees with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    return {"probes": ROTATION_PROBES, "angles": 8, "seconds": dt, "metrics": got,
            "card_vs_cpu": err, "launches": launches}


def pretrain_stn_phase(tmp: Path):
    """pretrain_stn end to end for 2 epochs on the entry points' data, then
    train_rvae for one epoch from the STN it saved."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    stn_ckpt = tmp / "stn" / "stn_pretrained.pt"
    args = pretrain_stn.build_argparser().parse_args(
        [*FRAMES, "--val-split", "0.25", "--epochs", str(PRETRAIN_EPOCHS),
         "--checkpoint", str(stn_ckpt)])
    torch.cuda.synchronize()
    zero_counts()
    out, _ = _quiet(pretrain_stn.run_pretrain, args)
    torch.cuda.synchronize()
    launches = counts()
    n, n_train, n_val = out["sites"]
    check(n_val % BATCH and (n_val % BATCH, *SHAPE[1:]) in PATH_SHAPES,
          f"the kernel phase did not hold rot3 at the pretraining's val tail {n_val % BATCH}")
    # one rot3 forward per batch (the paired extraction's rotation); the
    # localisation net neither rotates nor differentiates a rotation; one paired
    # localisation pass per batch, its backward per train step
    for e in out["epochs"]:
        check(e["steps"] == n_train // BATCH and e["val_batches"] == -(-n_val // BATCH),
              f"pretrain_stn epoch {e['epoch']} batches {e['steps']} / {e['val_batches']}")
        want = launches_of((rvae(0, 0, 1, 1, rot3_fwd=1), e["steps"]),
                           (rvae(0, 0, 1, 0, rot3_fwd=1), e["val_batches"]))
        check(e["launches"] == want, f"pretrain_stn epoch {e['epoch']} launches {e['launches']}, "
                                     f"expected {want}")
        check(math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"]),
              f"pretrain_stn epoch {e['epoch']} losses {e['train_loss']}, {e['val_loss']}")
    check(launches == {k: sum(e["launches"][k] for e in out["epochs"]) for k in launches},
          f"pretrain_stn launched {launches} outside its epochs' counts")
    payload = load_checkpoint(stn_ckpt)
    want_keys = {f"{key}.{w}" for _, key, _, _ in stn_spec(PATCH) for w in ("weight", "bias")}
    check(set(payload) == {"rotation_stn", "epoch", "best_val", "args"}
          and set(payload["rotation_stn"]) == want_keys
          and payload["best_val"] == out["best_val"], f"STN checkpoint holds {sorted(payload)}")

    ckpt = tmp / "rvae_stn" / "rvae_best.pt"
    from_stn, r_launches, printed, _ = run_cli(train_rvae, [*CLI_DATA, "--epochs", "1",
                                                            "--stn-checkpoint", str(stn_ckpt),
                                                            "--checkpoint", str(ckpt)])
    check(f"Loaded pretrained STN from {stn_ckpt}" in printed, "train_rvae did not load the STN")
    _check_epochs(from_stn, "train_rvae --stn-checkpoint", per_step=PAIRED_STEP,
                  per_val_batch=PAIRED_EVAL)
    rates = [{"epoch": e["epoch"], "train_patches_per_s": e["steps"] * BATCH / e["train_s"],
              "eval_s": e["eval_s"]} for e in out["epochs"]]
    print("pretrain_stn: " + ", ".join(
        f"epoch {e['epoch']} train {e['train_loss']:.4f} val {e['val_loss']:.4f}"
        for e in out["epochs"]) + f"; then train_rvae from it: loss "
        f"{from_stn['epochs'][0]['metrics']['train_loss']:.4f}")
    return {"sites": list(out["sites"]), "epochs": rates,
            "train_loss": [e["train_loss"] for e in out["epochs"]],
            "val_loss": [e["val_loss"] for e in out["epochs"]], "launches": launches,
            "train_rvae_from_stn": {"train_loss": from_stn["epochs"][0]["metrics"]["train_loss"],
                                    "launches": r_launches}}


def _lexsorted(sites, labels):
    order = np.lexsort((sites[:, 1], sites[:, 0]))
    return sites[order], labels[order]


def _final_max_peaks(shape, min_distance: int, n_valid: int) -> int:
    """The table size detect_atoms_device ends with for n_valid peaks: its
    first size, grown fourfold while every row is valid."""
    hard_cap = (shape[0] // max(min_distance, 1) + 1) * (shape[1] // max(min_distance, 1) + 1)
    size = min(16384, hard_cap)
    while n_valid >= size and size < hard_cap:
        size = min(hard_cap, size * 4)
    return size


def device_peaks_phase():
    """The site table with device_peaks=True against the host build, on the
    bench frame and on a 2048-pixel frame (the reference's frame size), at
    patch 128 and padding 32; then the device filters on the 2048 frame, card
    against the same port on the CPU. No kernel of the port runs here."""
    torch.cuda.synchronize()
    zero_counts()
    frames = []
    for size in (1024, 2048):
        raw, _ = synthetic_mos2_frame(size=size, spacing=40.0, seed=0)
        img = host_bandpass_normalize(raw, 20, 100)
        spacing = estimate_lattice_constant(img, device="cuda")
        min_distance = int(spacing * 0.15)
        t0 = time.perf_counter()
        host = build_adaptive_lattice(img, PATCH, PADDING, lattice_spacing=spacing, device="cuda")
        host_s = time.perf_counter() - t0
        dev_s = []
        for _ in range(2):  # the first call meets cuFFT's and the sort's first launches
            t0 = time.perf_counter()
            dev = build_adaptive_lattice(img, PATCH, PADDING, lattice_spacing=spacing,
                                         device_peaks=True, device="cuda")
            dev_s.append(time.perf_counter() - t0)
        cpu = build_adaptive_lattice(img, PATCH, PADDING, lattice_spacing=spacing,
                                     device_peaks=True, device="cpu")
        atoms_dev = detect_atoms_device(img, min_distance, device="cuda")
        atoms_host = get_clean_peaks(img, min_distance=min_distance)
        check(np.array_equal(atoms_dev, atoms_host),
              f"{size} frame: the device atoms are not the host's, in its order")
        check(np.array_equal(dev[0], cpu[0]) and np.array_equal(dev[1], cpu[1]),
              f"{size} frame: the device site table on the card differs from the CPU's")
        equal = (len(dev[0]) == len(host[0])
                 and all(np.array_equal(a, b) for a, b in zip(_lexsorted(*dev[:2]),
                                                              _lexsorted(*host[:2]))))
        # a float64 frame is ranked in float64 on the card, so the atoms come in
        # the host's order and the tables are equal row for row, not only as sets
        same_rows = np.array_equal(dev[0], host[0]) and np.array_equal(dev[1], host[1])
        entry = {
            "size": size, "spacing": spacing, "min_distance": min_distance,
            "atoms": len(atoms_dev), "sites_host": len(host[0]), "sites_device": len(dev[0]),
            "equal_as_sets": bool(equal), "equal_rows": bool(same_rows),
            "host_build_s": host_s, "device_build_s": dev_s,
            "max_peaks": _final_max_peaks(img.shape, min_distance, len(atoms_dev)),
        }
        frames.append(entry)
        print(f"device_peaks {size}: {len(dev[0])} sites on the device, {len(host[0])} on the "
              f"host, equal as sets: {equal}, row for row: {same_rows}; atoms "
              f"{len(atoms_dev)} equal; host build {host_s:.3f} s, device build "
              f"{dev_s[1]:.3f} s (first {dev_s[0]:.3f} s), max_peaks {entry['max_peaks']}")
        check(equal and same_rows, f"{size} frame: the device site table is not the host's")
        if size == 1024:
            check(len(dev[0]) == 1409, "bench frame: the site table has not 1409 sites")
        last = (raw, img)

    raw, img = last
    dev_raw = torch.as_tensor(raw, dtype=torch.float32, device="cuda")
    filters = {
        "bandpass_filter": lambda t: bandpass_filter(t, 20, 100),
        "fft_spectra_magnitude": lambda t: fft_spectra(t)[0],
        "normalize_image": lambda t: normalize_image(bandpass_filter(t, 20, 100)),
    }
    tol = {"bandpass_filter": 1e-4, "fft_spectra_magnitude": 1e-5, "normalize_image": 1e-4}
    errs, ms = {}, {}
    for name, fn in filters.items():
        got = fn(dev_raw).cpu()
        want = fn(dev_raw.cpu())
        scale = float(want.abs().max())
        errs[name] = float((got - want).abs().max()) / scale
        ms[name] = median_ms(lambda: fn(dev_raw), reps=5, warmup=2, inner=5)
        # float32 FFTs of two libraries: the error is relative to the largest term
        print(f"filters 2048: {name} card vs CPU max_abs_err / max {errs[name]:.3e} "
              f"(tol {tol[name]:.0e}), {ms[name]:.4f} ms on the card")
        check(errs[name] <= tol[name], f"{name} on the card disagrees with the CPU")
    launches = counts()
    check(launches == NO_LAUNCH, f"device_peaks launched {launches}")
    return {"frames": frames, "filters_rel_err": errs, "filters_ms": ms, "launches": launches}


def _batches(dataset, gen, n: int):
    """n batches of `dataset.iter_epoch(gen, BATCH)`, epoch after epoch."""
    def forever():
        while True:
            yield from dataset.iter_epoch(gen, BATCH)
    return itertools.islice(forever(), n)


HOST_LOOP_STEPS, HOST_LOOP_VAL = 4, 2


def host_loop_phase(ds):
    """The host-loop trainers at batch 512, bf16, over the datasets' own
    iter_epoch batches: train_rvae_one_epoch (4 batches) and evaluate_rvae
    (2) on the bench frame's paired dataset, then train_one_epoch (4) and
    evaluate (2) with the plain VAE on PatchDataset. A paired batch's
    extraction rotates once; the rVAE step rotates twice forward, twice
    backward; PatchDataset's extraction rotates once, the VAE not at all."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator(device="cuda").manual_seed(11)
    model = RVAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
                 generator=torch.Generator().manual_seed(12))
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    patches = PatchDataset([synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)[0]],
                           patch_size=PATCH, device="cuda")
    vae = VAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
              generator=torch.Generator().manual_seed(13))
    vopt = make_optimizer(vae, 1e-3, optimizer="adam")
    runs = [
        ("train_rvae_one_epoch", lambda log: train_rvae_one_epoch(
            make_rvae_train_step(model, opt, device="cuda"), _batches(ds, gen, HOST_LOOP_STEPS), 0, log,
            10.0, 10.0), HOST_LOOP_STEPS, PAIRED_STEP),
        ("evaluate_rvae", lambda log: evaluate_rvae(
            make_rvae_eval_step(model, device="cuda"), _batches(ds, gen, HOST_LOOP_VAL), 1, log, 10.0, 10.0),
         HOST_LOOP_VAL, PAIRED_EVAL),
        ("train_one_epoch", lambda log: train_one_epoch(
            make_train_step(vae, vopt, device="cuda"), _batches(patches, gen, HOST_LOOP_STEPS), 2, log),
         HOST_LOOP_STEPS, {"rot3_fwd": 1}),
        ("evaluate", lambda log: evaluate(
            make_eval_step(vae, device="cuda"), _batches(patches, gen, HOST_LOOP_VAL), 3, log),
         HOST_LOOP_VAL, {"rot3_fwd": 1}),
    ]
    result, total = {}, dict(NO_LAUNCH)
    for name, run, n, per_batch in runs:
        log = MetricLogger()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        means = run(log)  # ends in the epoch's one host read
        dt = time.perf_counter() - t0
        got = counts()
        want = {**NO_LAUNCH, **{k: v * n for k, v in per_batch.items()}}
        check(got == want, f"{name} launches {got}, expected {want}")
        check(bool(means) and all(math.isfinite(v) for v in means.values()),
              f"{name} epoch means {means}")
        for k in total:
            total[k] += got[k]
        result[name] = {"batches": n, "seconds": dt, "patches_per_s": n * BATCH / dt,
                        "loss": means[("train_" if name.startswith("train") else "val_") + "loss"],
                        "launches": got}
        print(f"host_loop: {name} {n} batches in {dt:.3f} s ({n * BATCH / dt:.1f} patches/s), "
              f"loss {result[name]['loss']:.4f}, launches {got}")
    result["launches"] = total
    return result


SWEEP_DATA = [*FRAMES, "--val-split", "0.25"]
# per train step of a trial (the fused VAE step on the rVAE: the STN's rotation
# and the inverse rotation, each backward; a decoder and a localisation pass,
# each backward) and per val batch of its fused eval
SWEEP_PER_STEP = rvae(1, 1, 1, 1, rot3_fwd=2, rot3_bwd=2)
SWEEP_PER_VAL = rvae(1, 0, 1, 0, rot3_fwd=2)
SWEEP_RUNS = {
    "asha": ["--num-samples", "4", "--max-concurrent", "2", "--epochs", "3",
             "--grace-period", "1"],
    # PBT exploits only with two peers that have reported: 2 trials never do.
    # 4 trials, 2 at a time, with one latent width (a donor's weights fit) and
    # lr and beta fixed at first (the losses compare): a trial of the second
    # pair, one epoch in, is then the worst beside the first pair's three
    "pbt": ["--scheduler", "pbt", "--perturbation-interval", "1", "--num-samples", "4",
            "--max-concurrent", "2", "--epochs", "3", "--latent-dims", "16",
            "--lr-min", "1e-3", "--lr-max", "1e-3", "--beta-min", "1", "--beta-max", "1"],
    "process": ["--executor", "process", "--max-concurrent", "1", "--num-samples", "1",
                "--epochs", "1"],
}
BEST_CONFIG_KEYS = ["lr", "latent_dim", "beta", "weight_decay", "batch_size", "normalize",
                    "gamma", "patch_size", "padding", "val_split", "epochs", "beta_annealing",
                    "beta_annealing_epochs", "grad_max_norm"]  # the JAX script's


def _sweep_expected(history) -> dict:
    want = dict(NO_LAUNCH)
    for m in history:
        for k, v in SWEEP_PER_STEP.items():
            want[k] += v * m["steps"]
        for k, v in SWEEP_PER_VAL.items():
            want[k] += v * m["val_batches"]
    return want


def sweep_phase(tmp: Path, sites):
    """python -m livae_tpu_torch.scripts.train_rvae_raytune as a process, three
    runs (ASHA with TPE, PBT, the process executor) on the entry points' data
    at the CLI's widths; then train_rvae_with_best in-process on the ASHA run's
    best_config.json, compare_training_methods, and analyze_raytune_results
    where pandas is importable. `sites` is train_rvae's (all, train, val) on
    the same data and split."""
    root = Path(__file__).resolve().parent
    n_val = sites[2]
    check((n_val % BATCH, *SHAPE[1:]) in PATH_SHAPES,
          f"the kernel phase did not hold rot3 at the sweep's val tail {n_val % BATCH}")
    torch.cuda.empty_cache()
    runs = {}
    for name, flags in SWEEP_RUNS.items():
        best_path = tmp / "sweep" / name / "best_config.json"
        cmd = [sys.executable, "-m", "livae_tpu_torch.scripts.train_rvae_raytune", *SWEEP_DATA,
               *flags, "--ray-results-dir", str(tmp / "ray_results"), "--experiment-name", name,
               "--save-best-config", str(best_path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
        seconds = time.perf_counter() - t0
        sys.stderr.write(proc.stderr[-3000:])
        check(proc.returncode == 0, f"sweep {name} exited {proc.returncode}: "
              f"{proc.stdout[-1500:]}")
        summary = json.loads(next(line for line in proc.stdout.splitlines()
                                  if line.startswith("sweep_summary "))[len("sweep_summary "):])
        trials = json.loads((tmp / "ray_results" / name / "results.json").read_text())
        check(len(trials) == summary["trials"] and all(t["status"] in ("done", "stopped")
                                                        for t in trials),
              f"sweep {name} trials {[t['status'] for t in trials]}")
        want = dict(NO_LAUNCH)
        for t in trials:
            check(len(t["history"]) == t["epochs"] >= 1, f"sweep {name} trial {t['trial_id']}")
            for m in t["history"]:
                check(all(math.isfinite(m[k]) for k in ("loss", "train_loss", "val_psnr")),
                      f"sweep {name} trial {t['trial_id']} epoch {m['epoch']} metrics {m}")
                check(m["val_batches"] == -(-n_val // BATCH) and m["steps"] == sites[1] // BATCH,
                      f"sweep {name} batches {m}")
            for k, v in _sweep_expected(t["history"]).items():
                want[k] += v
        if name == "process":  # the launches are the child's, in its reports
            (t,) = trials
            got = {k: t["history"][-1][k] for k in NO_LAUNCH}
            check(t["history"][-1]["pid"] != summary["pid"] and t["history"][-1]["slot"] == "0",
                  "the process trial did not run in a child of slot 0")
        else:
            got = summary["launches"]
        check(got == want, f"sweep {name} launches {got}, expected {want}")
        best = json.loads(best_path.read_text())
        check(list(best) == BEST_CONFIG_KEYS, f"sweep {name} best_config keys {list(best)}")
        exploits = [line for line in proc.stdout.splitlines() if "PBT exploit" in line]
        loaded = sum("loaded donor checkpoint" in line for line in exploits)
        if name == "pbt":
            print(f"sweep pbt: {len(exploits)} exploits, {loaded} loaded a donor checkpoint")
            check(loaded > 0, "no PBT exploit loaded a donor checkpoint")
        rates = [m["train_patches_per_s"] for t in trials for m in t["history"]]
        peak = max([summary["max_memory_gib"]]
                   + [m["max_memory_gib"] for t in trials for m in t["history"]])
        runs[name] = {
            "seconds": seconds, "kernel_build_s": summary["kernel_build_s"],
            "search_s": summary["seconds"], "trials": len(trials),
            "statuses": [t["status"] for t in trials], "epochs": [t["epochs"] for t in trials],
            "latent_dims": [t["config"]["latent_dim"] for t in trials],
            "train_patches_per_s": rates, "best_loss": min(t["loss"] for t in trials),
            "peak_memory_gib": peak, "launches": got, "exploits": len(exploits),
            "exploits_loaded": loaded,
        }
        print(f"sweep {name}: {len(trials)} trials {runs[name]['statuses']} in {seconds:.1f} s "
              f"(search {summary['seconds']:.1f} s); train patches/s per trial epoch "
              f"{min(rates):.0f}-{max(rates):.0f}; peak {peak:.3f} GiB; launches {got}")

    # retrain from the ASHA run's best config, one epoch at the CLI's defaults
    best_cfg = json.loads((tmp / "sweep" / "asha" / "best_config.json").read_text())
    ckpt = tmp / "sweep" / "retrain" / "rvae_best.pt"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out, printed = _quiet(train_rvae_with_best.main, [
        "--config", str(tmp / "sweep" / "asha" / "best_config.json"), "--override-epochs", "1",
        *CLI_DATA, "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    launches = counts()
    check("Loaded best config from" in printed, "train_rvae_with_best did not read the config")
    _check_epochs(out, "train_rvae_with_best", per_step=PAIRED_STEP, per_val_batch=PAIRED_EVAL)
    check(launches == out["epochs"][0]["launches"], f"with_best launches {launches}")
    state, payload = load_reference_checkpoint(out["final_checkpoint"])
    retrained = RVAE(int(best_cfg["latent_dim"]), 1, PATCH, "bfloat16", device="cuda")
    retrained.load_state_dict(state, strict=True)
    check(math.isclose(payload["args"]["lr"], best_cfg["lr"]) and
          payload["args"]["latent_dim"] == best_cfg["latent_dim"],
          "the retrain's checkpoint does not carry the best config")
    runs["with_best"] = {"latent_dim": best_cfg["latent_dim"], "epochs": _epoch_rates(out),
                         "train_loss": out["epochs"][0]["metrics"]["train_loss"],
                         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "launches": launches}

    rows, _ = _quiet(compare_training_methods.main, [
        "--checkpoint", str(ckpt), "--results-dir", str(tmp / "ray_results" / "asha"),
        "--out", str(tmp / "sweep" / "method_comparison.png")])
    check([r["method"] for r in rows] == ["standard", "sweep (best trial)"],
          "compare_training_methods rows")
    missing = _missing("pandas")
    if missing:
        print(f"sweep: skipped analyze_raytune_results: {', '.join(missing)} is not importable "
              f"here")
    else:
        _quiet(analyze_raytune_results.main, ["--results-dir", str(tmp / "ray_results" / "asha"),
                                              "--csv", str(tmp / "sweep" / "asha.csv")])
        check((tmp / "sweep" / "asha.csv").exists(), "analyze_raytune_results wrote no CSV")
    return runs


STACK_K, STACK_EPOCHS = 4, 2
# rot3 under vmap, as (lanes, canvases per lane): 2 lanes of the main path's
# batch, the stacked phase's folded batches (K x 512 train and val steps, K x
# 193 for the val tail) and 8 x 512 = 4096 canvases (268 M elements: the
# launch plan and rot3.cu's long index arithmetic at bench_stacked's K = 8)
VMAP_ROT3_LANES = [(2, BATCH), (STACK_K, BATCH), (STACK_K, 193), (8, BATCH)]


class _PlainShift(torch.autograd.Function):
    """Kernel C's plain version with the JAX package's VJP
    (`fractional_shift_vjp_reference`), which the kernel's backward follows."""

    @staticmethod
    def forward(x, delta, axis):
        return SH.fractional_shift_reference(x, delta, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, delta, axis = inputs
        ctx.axis = axis
        ctx.save_for_backward(x, delta)

    @staticmethod
    def backward(ctx, g):
        x, delta = ctx.saved_tensors
        dx, ddelta = SH.fractional_shift_vjp_reference(x, delta, g, ctx.axis)
        return dx, ddelta, None


def _vmap_kernel_checks():
    """The kernels under torch.func.vmap (the stacked trials' rule: the lanes
    fold into the batch, one launch) against their plain versions lane by
    lane: rot3 at VMAP_ROT3_LANES in bf16 (and 2 lanes in f32) with the shifts
    of real rotations, and rotate_image_fast(backend="shear") on
    [2, 64, 3, 128, 128] (kernel C). Forward and dx bit-equal; the delta and
    angle gradients at the kernel phases' 1e-4 x max(1, scale)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    P = SHAPE[1]
    result = {}
    cases = [(k, b, torch.bfloat16) for k, b in VMAP_ROT3_LANES] + [(2, BATCH, torch.float32)]
    for K, B, dtype in cases:
        x = torch.randn((K, B, P, P), device=dev, generator=gen).to(dtype)
        w = torch.randn((K, B, P, P), device=dev, generator=gen).to(dtype)
        d_row, d_col = (d.unflatten(0, (K, B)) for d in _deltas("rotation", gen, K * B, P))
        ins = [t.clone().requires_grad_(True) for t in (x, d_row, d_col)]
        zero_counts()
        y = torch.func.vmap(R.Rot3Function.apply)(*ins)
        gk = torch.autograd.grad(y, ins, w)
        torch.cuda.synchronize()
        launched = counts()
        check(launched["rot3_fwd"] == 1 and launched["rot3_bwd"] == 1,
              f"rot3 under vmap over {K} lanes launched {launched}, not once each way")
        fe, ge, scale = 0.0, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        for k in range(K):  # the plain version lane by lane
            lane = [t[k].detach().clone().requires_grad_(True) for t in (x, d_row, d_col)]
            y_ref = R.rot3_reference(*lane)
            gr = torch.autograd.grad(y_ref, lane, w[k])
            fe = max(fe, (y[k].float() - y_ref.float()).abs().max().item())
            for i in range(3):
                ge[i] = max(ge[i], (gk[i][k].float() - gr[i].float()).abs().max().item())
                scale[i] = max(scale[i], gr[i].float().abs().max().item())
            del y_ref, gr, lane
        tol = [1e-4 * max(1.0, v) for v in scale[1:]]
        what = f"rot3 under vmap [{K}, {B}, {P}, {P}] {str(dtype)[6:]}"
        print(f"{what}: one launch each way on {K * B} canvases; fwd max_abs_err {fe:.3e} "
              f"(tol 0) dx {ge[0]:.3e} (tol 0) d_row {ge[1]:.3e} (tol {tol[0]:.1e}) "
              f"d_col {ge[2]:.3e} (tol {tol[1]:.1e})")
        check(fe == 0.0 and ge[0] == 0.0, f"{what}: forward or dx differs from the plain version")
        check(ge[1] <= tol[0] and ge[2] <= tol[1], f"{what}: delta gradients")
        result[f"rot3 {K}x{B} {str(dtype)[6:]}"] = {"fwd": fe, "dx": ge[0], "d_row": ge[1],
                                                    "d_col": ge[2]}
        del x, w, d_row, d_col, ins, y, gk
        torch.cuda.empty_cache()

    # kernel C: three channels take the per-shear path
    from livae_tpu_torch.ops import resample as RS

    K, B, C, S = 2, 64, 3, PATCH
    x = torch.rand((K, B, C, S, S), device=dev, generator=gen)
    w = torch.randn((K, B, C, S, S), device=dev, generator=gen)
    theta = (torch.rand((K, B, 1), device=dev, generator=gen) - 0.5) * 2 * math.pi
    ins = [x.clone().requires_grad_(True), theta.clone().requires_grad_(True)]
    zero_counts()
    y = torch.func.vmap(lambda a, t: rotate_image_fast(a, t, backend="shear"))(*ins)
    gk = torch.autograd.grad(y, ins, w)
    torch.cuda.synchronize()
    launched = counts()
    check(launched == {**NO_LAUNCH, "shear_fwd": 3, "shear_bwd": 3},
          f"rotate_image_fast(shear) under vmap launched {launched}")
    kernel_shift = RS.fractional_shift
    RS.fractional_shift = _PlainShift.apply
    try:
        fe = dxe = dte = dts = 0.0
        for k in range(K):
            lane = [x[k].clone().requires_grad_(True), theta[k].clone().requires_grad_(True)]
            y_ref = rotate_image_fast(*lane, backend="shear")
            gr = torch.autograd.grad(y_ref, lane, w[k])
            fe = max(fe, (y[k] - y_ref).abs().max().item())
            dxe = max(dxe, (gk[0][k] - gr[0]).abs().max().item())
            dte = max(dte, (gk[1][k] - gr[1]).abs().max().item())
            dts = max(dts, gr[1].abs().max().item())
    finally:
        RS.fractional_shift = kernel_shift
    tol = 1e-4 * max(1.0, dts)
    print(f"rotate_image_fast(shear) under vmap {[K, B, C, S, S]} f32: 3 launches each way on "
          f"{K * B * C} canvases of {S + 2 * aligned_margin(S)}; fwd max_abs_err {fe:.3e} (tol 0) "
          f"dx {dxe:.3e} (tol 0) d theta {dte:.3e} (tol {tol:.1e})")
    check(fe == 0.0 and dxe == 0.0, "rotate_image_fast(shear) under vmap: forward or dx differs")
    check(dte <= tol, "rotate_image_fast(shear) under vmap: the angle's gradient")
    result["shear 2x64x3"] = {"fwd": fe, "dx": dxe, "d_theta": dte}
    return result


def stacked_phase(tmp: Path, sites):
    """Stacked trials: the sweep CLI with --stacked 4 in-process on the entry
    points' data at the CLI's widths (4 lanes, 2 epochs, bf16), its rot3
    launches per epoch (2 per train step and 2 per val batch forward, 2 per
    train step backward, whatever K); lane 0's first train epoch in f32 (TF32
    off) against the sequential fused step of trial 0; the kernels under
    vmap against their plain versions."""
    from livae_tpu_torch.scripts import train_rvae_raytune
    from livae_tpu_torch.scripts._common import epoch_index_batches, split_indices, stream_generator
    from livae_tpu_torch.sweep import make_stacked_fns, set_stacked_hyperparams
    from livae_tpu_torch.sweep.stacked import StackedState
    from livae_tpu_torch.train.engine import make_fused_vae_train_step

    n, n_train, n_val = sites
    steps, val_batches = n_train // BATCH, -(-n_val // BATCH)
    check(val_batches == 2 and n_val % BATCH == VMAP_ROT3_LANES[2][1],
          f"the vmap checks do not hold rot3 at the stacked val tail {STACK_K} x {n_val % BATCH}")
    result = {"vmap_checks": _vmap_kernel_checks()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = train_rvae_raytune.build_argparser().parse_args([
        *SWEEP_DATA, "--stacked", str(STACK_K), "--num-samples", str(STACK_K),
        "--epochs", str(STACK_EPOCHS), "--latent-dims", "16", "--ray-results-dir",
        str(tmp / "ray_results"), "--experiment-name", "stacked", "--save-best-config",
        str(tmp / "stacked" / "best_config.json")])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out, printed = _quiet(train_rvae_raytune.run_hyperparameter_search, args)
    seconds = time.perf_counter() - t0
    launches = counts()
    check("note: --stacked ignores --scheduler asha" in printed, "no scheduler note")
    trials = out["trials"]
    check(len(trials) == STACK_K and all(t.status == "done" for t in trials),
          f"stacked trials {[t.status for t in trials]}")
    want = launches_of((SWEEP_PER_STEP, STACK_EPOCHS * steps),
                       (SWEEP_PER_VAL, STACK_EPOCHS * val_batches))
    check(launches == want and out["launches"] == want,
          f"stacked launches {launches}, expected {want} (independent of K)")
    for t in trials:
        check(len(t.history) == STACK_EPOCHS and Path(t.checkpoint).exists(),
              f"stacked trial {t.trial_id}")
        for m in t.history:
            check(m["lanes"] == STACK_K and m["steps"] == steps and m["val_batches"] == val_batches
                  and all(math.isfinite(m[k]) for k in ("loss", "train_loss", "val_psnr")),
                  f"stacked trial {t.trial_id} epoch {m['epoch']}: {m}")
    rates = [t.history[e]["train_patches_per_s"] for t in trials[:1] for e in range(STACK_EPOCHS)]
    peak = out["max_memory_gib"]
    result.update(lanes=STACK_K, epochs=STACK_EPOCHS, seconds=seconds, search_s=out["seconds"],
                  train_patches_per_s=rates, peak_memory_gib=peak,
                  peak_memory_gib_per_lane=peak / STACK_K, launches=launches,
                  launches_per_epoch={k: v // STACK_EPOCHS for k, v in launches.items()},
                  train_loss=[t.history[0]["train_loss"] for t in trials])
    print(f"stacked: {STACK_K} lanes x {STACK_EPOCHS} epochs in {seconds:.1f} s; stack train "
          f"patches/s per epoch {', '.join(f'{r:.1f}' for r in rates)}; peak {peak:.3f} GiB "
          f"({peak / STACK_K:.3f} per lane); launches {launches} ({steps} steps and "
          f"{val_batches} val batches per epoch)")

    # lane 0 against trial 0 alone, in f32 with TF32 off (the same data and split)
    torch.backends.cudnn.allow_tf32 = False
    ds = AdaptiveLatticeDataset(
        [synthetic_mos2_frame(size=1024, spacing=40.0, seed=s)[0] for s in range(2)],
        patch_size=PATCH, padding=PADDING, transform=default_transform, device="cuda")
    train_idx, _ = split_indices(len(ds), 0.25, seed=0)
    train_idx = torch.as_tensor(train_idx, dtype=torch.long, device="cuda")
    table = ds.device_site_table[:3]
    mk = dict(patch_size=PATCH, padding=PADDING, cfg=ds.transform, margin=ds._margin,
              grad_max_norm=20.0, device="cuda")
    lrs, betas = [1e-3, 3e-4], [1.0, 4.0]

    def f32_model(seed):
        return RVAE(16, 1, PATCH, None, device="cuda",
                    generator=stream_generator(seed, "init", 0, "cpu"))

    gens = [stream_generator(i, "train", 0, "cuda") for i in range(2)]
    idx = torch.stack([epoch_index_batches(train_idx, BATCH, g) for g in gens])
    models = [f32_model(i) for i in range(2)]
    stacked_step, _ = make_stacked_fns(models[0], **mk)
    state = set_stacked_hyperparams(StackedState.create(models), lrs, [1e-5, 1e-5])
    _, stacked = stacked_step(state, *table, idx, gens, betas, [0.0, 0.0])
    model = f32_model(0)
    step = make_fused_vae_train_step(
        model, make_optimizer(model, lrs[0], optimizer="adamw", weight_decay=1e-5), **mk)
    gen = stream_generator(0, "train", 0, "cuda")
    sequential = step(*table, epoch_index_batches(train_idx, BATCH, gen), gen, betas[0], 0.0)
    got, want = float(stacked["loss"][0]), float(sequential["loss"])
    rel = abs(got - want) / abs(want)
    print(f"stacked: f32 lane 0 train loss {got:.6f}, trial 0 alone {want:.6f}, relative "
          f"difference {rel:.3e} (tol 2e-4)")
    check(rel <= 2e-4, "stacked lane 0 disagrees with the sequential trial")
    torch.backends.cudnn.allow_tf32 = True
    result["f32_lane0_rel_diff"] = rel
    return result


def compare_phase(tmp: Path):
    """The comparison harnesses: compare_vae_rvae at its defaults,
    compare_resample_elbo --synthetic 1 --train-epochs 1, and
    accuracy_program at its quickest grid (one beta, no ablation, 2 epochs,
    one training frame) at the CLI's widths; each one's rot3 launches."""
    from livae_tpu_torch.scripts import accuracy_program, compare_resample_elbo, compare_vae_rvae

    result = {}
    zero_counts()
    cmp, _ = _quiet(compare_vae_rvae.main, [])
    launches = counts()
    # the smoke test's forward and backward, then 3 + 100 timed forwards of the
    # rVAE: each forward the STN's rotation and the inverse one on [32, 128, 128],
    # a decoder and a localisation pass
    want = launches_of((rvae(1, 0, 1, 0, rot3_fwd=2), 104), (rvae(0, 1, 0, 1, rot3_bwd=2), 1))
    check(cmp["ok"] and launches == want, f"compare_vae_rvae {cmp['ok']} launches {launches}")
    result["compare_vae_rvae"] = {k: cmp[k] for k in ("vae_params", "rvae_params", "vae_ms",
                                                      "vae_imgs_per_s", "rvae_ms",
                                                      "rvae_imgs_per_s")}
    result["compare_vae_rvae"]["launches"] = launches
    print(f"compare_vae_rvae: VAE {cmp['vae_imgs_per_s']:.0f}, rVAE {cmp['rvae_imgs_per_s']:.0f} "
          f"imgs/s (batch 32, patch 64, f32); params {cmp['vae_params']} / {cmp['rvae_params']}")

    zero_counts()
    elbo, _ = _quiet(compare_resample_elbo.main, compare_resample_elbo.build_argparser().parse_args(
        ["--synthetic", "1", "--train-epochs", "1"]))
    launches = counts()
    bs, nb = elbo["batch_size"], elbo["batches"]
    check((bs, *SHAPE[1:]) in PATH_SHAPES, f"the kernel phase did not hold rot3 at [{bs}, 256, 256]")
    steps = 1269 // bs  # the bench frame's 1409 sites, a tenth held out
    # train: paired steps; per eval batch the extraction's rotation and two paired
    # evals, the fast objective's with 2 rot3 forwards, the exact one's with none
    want = launches_of((PAIRED_STEP, steps), (rvae(2, 0, 2, 0, rot3_fwd=3), nb))
    check(launches == want, f"compare_resample_elbo launches {launches}, expected {want}")
    check(math.isfinite(elbo["relative_delta"]), f"compare_resample_elbo {elbo}")
    result["compare_resample_elbo"] = {**elbo, "launches": launches}
    print(f"compare_resample_elbo: fast {elbo['fast_objective']:.6f}, exact "
          f"{elbo['exact_objective']:.6f}, relative delta {elbo['relative_delta']:.3e}; the "
          f"{elbo['gate']:.0%} gate {'holds' if elbo['passes_1pct_gate'] else 'FAILS'}")

    zero_counts()
    args = accuracy_program.parse_args(["--betas", "1.0", "--no-norm-ablation", "--epochs", "2",
                                        "--train-frames", "1", "--out",
                                        str(tmp / "accuracy.json")])
    t0 = time.perf_counter()
    (row,), printed = _quiet(accuracy_program.main, args)
    seconds = time.perf_counter() - t0
    launches = counts()
    n_held = row["eval_sites"]
    missing = _missing("sklearn")
    if missing:
        print(f"compare: accuracy_program skipped kmeans_ari, linear_accuracy and vacancy_auc: "
              f"{', '.join(missing)} is not importable here")
        check("skipped kmeans_ari" in printed, "accuracy_program did not say what it skipped")
    check(math.isfinite(row["kld_mean"]) and math.isfinite(row["rot90_mu_cosine"])
          and math.isfinite(row["train_loss"]), f"accuracy_program row {row}")
    check((1446 % BATCH, *SHAPE[1:]) in PATH_SHAPES,
          "the kernel phase did not hold rot3 at the held-out frame's tail")
    # 2 paired train steps per epoch (1433 sites); the held-out frame's 1446 sites
    # in 3 batches of a forward (2 rot3 forwards); 2 probe encodes
    want = launches_of((PAIRED_STEP, 2 * 2), (rvae(1, 0, 1, 0, rot3_fwd=2), 3),
                       (ENCODE_BATCH, 2))
    check(launches == want, f"accuracy_program launches {launches}, expected {want}")
    result["accuracy_program"] = {**{k: row[k] for k in ("kld_mean", "rot90_mu_cosine",
                                                          "train_loss", "eval_sites",
                                                          "kmeans_ari")},
                                  "seconds": seconds, "launches": launches,
                                  "skipped": missing}
    print(f"compare: accuracy_program 1 config in {seconds:.1f} s, rot90 cosine "
          f"{row['rot90_mu_cosine']:.4f}, {n_held} matched held-out sites; launches {launches}")
    return result


PARALLEL_STEPS, PARALLEL_GLOO_STEPS = 3, 2


def _on(device, draws):
    return [PairedDraws(**{k: v.to(device) for k, v in vars(d).items()}) for d in draws]


def _dp_steps(mesh, device, state, table, idx, draws, eps, compute_dtype=None):
    """Fused rVAE train steps of a model loaded from `state` on `device`, as
    one rank of `mesh` (None: this process alone), with the global batches'
    draws and noise given. Returns the step means, the weights after (on the
    host) and the kernels' launches."""
    frames_padded, img_idx, coords, margin = table
    model = RVAE(LATENT, 1, PATCH, compute_dtype, device=device)
    model.load_state_dict(state)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    step = make_fused_rvae_train_step(model, opt, patch_size=PATCH, padding=PADDING,
                                      cfg=default_transform, margin=margin, canonical_weight=0.2,
                                      grad_max_norm=20.0, device=device, mesh=mesh)
    zero_counts()
    m = metrics_to_host(step(frames_padded.to(device), img_idx.to(device), coords.to(device),
                             idx.to(device), None, 10.0, 10.0, draws=_on(device, draws),
                             eps=[e.to(device) for e in eps]))
    torch.cuda.synchronize(device)
    return {"metrics": m, "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "launches": counts()}


def _gloo_rank(mesh, device, *args):
    """A rank of the 2-rank gloo run: CUDA tensors on the one card, f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _dp_steps(mesh, device, *args)


def _weights_diff(a, b) -> tuple[float, float]:
    """(max |a - b| over every weight, share of elements beyond 1e-5)."""
    d = torch.cat([(v.float() - b[k].float()).abs().reshape(-1) for k, v in a.items()])
    return float(d.max()), float((d > 1e-5).float().mean())


def _metrics_diff(a, b) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1.0))) for k in b)


def parallel_phase(ds):
    """Data parallelism (livae_tpu_torch.parallel) on the one card.

    1. World size 1 under NCCL, in this process: 3 fused rVAE steps at the
       main path's widths (batch 512, bf16) through DistributedDataParallel
       and the NCCL all-reduce, then one sharded eval batch (its all-gather),
       against the same steps and eval without a mesh from the same weights
       and draws: the weights equal, the metrics within 1e-6.
    2. Two gloo ranks, spawned, each with CUDA tensors on the card (NCCL
       refuses two ranks on one device): 2 steps at batch 512 (256 rows per
       rank) in f32 with TF32 off, against one process: the step means within
       1e-5, the weights within 1e-5 but for Adam's near-zero-gradient flips
       (fewer than 0.1 %, within 2 lr per step). Gloo cannot all-gather CUDA
       tensors, so the diversity term stays off here; the CPU tests hold it.
    """
    import torch.distributed as dist

    from livae_tpu_torch.parallel import init_mesh, spawn

    fp, img_idx, coords, margin = ds.device_site_table
    n = len(ds)
    g = torch.Generator().manual_seed(31)
    start = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(30))
    state = {k: v.clone() for k, v in start.state_dict().items()}

    def batches(steps):
        idx = torch.randint(0, n, (steps, BATCH), generator=g)
        draws = [sample_paired_draws(BATCH, default_transform, g, "cpu") for _ in range(steps)]
        return idx, draws, [torch.randn((BATCH, LATENT), generator=g) for _ in range(steps)]

    table = (fp, img_idx, coords, margin)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    idx, draws, eps = batches(PARALLEL_STEPS)
    vidx = torch.randint(0, n, (1, BATCH), generator=g)
    vdraws = [sample_paired_draws(BATCH, default_transform, g, "cpu")]
    veps = [torch.randn((BATCH, LATENT), generator=g)]

    def eval_batch(mesh):
        model = RVAE(LATENT, 1, PATCH, "bfloat16", device="cuda")
        model.load_state_dict(state)
        ev = make_fused_rvae_eval(model, patch_size=PATCH, padding=PADDING,
                                  cfg=default_transform, margin=margin, canonical_weight=0.2,
                                  device="cuda", mesh=mesh)
        return metrics_to_host(ev(fp, img_idx, coords, vidx.cuda(), None, 10.0, 10.0,
                                  draws=_on("cuda", vdraws), eps=[e.cuda() for e in veps]))

    plain = _dp_steps(None, torch.device("cuda"), state, table, idx, draws, eps, "bfloat16")
    plain_eval = eval_batch(None)
    with tempfile.TemporaryDirectory(prefix="livae_ranks_") as store:
        mesh = init_mesh(0, 1, "nccl", store)
        try:
            t0 = time.perf_counter()
            nccl = _dp_steps(mesh, torch.device("cuda"), state, table, idx, draws, eps,
                             "bfloat16")
            nccl_s = time.perf_counter() - t0
            nccl_eval = eval_batch(mesh)
        finally:
            dist.destroy_process_group()
    n_max, _ = _weights_diff(nccl["state"], plain["state"])
    n_diff = max(_metrics_diff(nccl["metrics"], plain["metrics"]),
                 _metrics_diff(nccl_eval, plain_eval))
    print(f"parallel: NCCL world 1, {PARALLEL_STEPS} steps bf16 batch {BATCH}: weights max diff "
          f"{n_max:.3e}, metrics max rel diff {n_diff:.3e} (tol 1e-6), launches "
          f"{nccl['launches']}, {nccl_s:.2f} s")
    check(n_max == 0.0 and n_diff <= 1e-6, "NCCL world-1 steps differ from one process")
    want = launches_of((PAIRED_STEP, PARALLEL_STEPS))
    check(nccl["launches"] == want, f"NCCL run launches {nccl['launches']}")

    idx, draws, eps = batches(PARALLEL_GLOO_STEPS)
    host_table = (fp.cpu(), img_idx.cpu(), coords.cpu(), margin)
    torch.backends.cudnn.allow_tf32 = False
    one = _dp_steps(None, torch.device("cuda"), state, host_table, idx, draws, eps)
    t0 = time.perf_counter()
    two = spawn(_gloo_rank, 2, state, host_table, idx, draws, eps, device_type="cuda",
                backend="gloo", root=tempfile.gettempdir())
    gloo_s = time.perf_counter() - t0
    w_max, w_share = _weights_diff(two["state"], one["state"])
    m_diff = _metrics_diff(two["metrics"], one["metrics"])
    print(f"parallel: 2 gloo ranks on the card, {PARALLEL_GLOO_STEPS} steps f32 batch {BATCH}: "
          f"metrics max rel diff {m_diff:.3e} (tol 1e-5), weights max diff {w_max:.3e}, "
          f"share beyond 1e-5 {w_share:.2e}, rank 0 launches {two['launches']}, {gloo_s:.1f} s")
    check(m_diff <= 1e-5 and w_share < 1e-3 and w_max <= 2 * 1e-3 * PARALLEL_GLOO_STEPS,
          "2 gloo ranks differ from one process")
    want = launches_of((PAIRED_STEP, PARALLEL_GLOO_STEPS))
    check(two["launches"] == want, f"gloo rank 0 launches {two['launches']}")
    torch.backends.cudnn.allow_tf32 = True  # the bf16 paths' setting, as the main path left it
    return {"nccl_world1": {"steps": PARALLEL_STEPS, "weights_max_diff": n_max,
                            "metrics_max_rel_diff": n_diff, "seconds": nccl_s,
                            "launches": nccl["launches"]},
            "gloo_2_ranks": {"steps": PARALLEL_GLOO_STEPS, "metrics_max_rel_diff": m_diff,
                             "weights_max_diff": w_max, "weights_share_beyond_1e-5": w_share,
                             "seconds": gloo_s, "launches": two["launches"]},
            "launches": nccl["launches"], "gloo_launches": two["launches"]}


TP_STEPS = 2
# rank 0's share of the split layers at patch 128 over 2 model ways: half of
# the four weights' 1,835,008 elements and half of decoder.fc's 16,384 biases
TP_PARAMS_SAVED = 1_835_008 // 2 + 16_384 // 2


def _tp_run(mesh, device, state, table, idx, draws, eps, vidx, vdraws, veps, probe,
            eval_state=None):
    """TP_STEPS fused rVAE train steps (diversity on) and one fused eval batch
    of an f32 model loaded from `state`, its large dense layers split over
    `mesh`'s model ways (None: this process alone, unsplit); the eval runs on
    the weights of `eval_state` (a one-device state dict, sliced again) where
    given. Returns the step and eval means, the one-device weights after the
    steps (on the host) and mu of `probe` under them, each rank's parameter
    count and bytes and rot3's launches."""
    import torch.distributed as dist

    from livae_tpu_torch.parallel import (
        dense_param_specs,
        full_state_dict,
        load_full_state_dict,
        place_with_specs,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames_padded, img_idx, coords, margin = (t.to(device) if torch.is_tensor(t) else t
                                              for t in table)
    model = RVAE(LATENT, 1, PATCH, device=device)
    model.load_state_dict(state)
    if mesh is not None:
        place_with_specs(model, mesh, dense_param_specs(model, mesh.model_size))
    held = torch.tensor([[sum(p.numel() for p in model.parameters()),
                          sum(p.numel() * p.element_size() for p in model.parameters())]],
                        dtype=torch.float64)
    if mesh is not None:  # every rank's figures, on the host (gloo)
        held = torch.zeros((mesh.size * mesh.model_size, 2), dtype=torch.float64).index_copy_(
            0, torch.tensor([mesh.world_rank]), held)
        dist.all_reduce(held)
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    kw = dict(patch_size=PATCH, padding=PADDING, cfg=default_transform, margin=margin,
              use_diversity=True, canonical_weight=0.2, device=device, mesh=mesh)
    step = make_fused_rvae_train_step(model, opt, grad_max_norm=20.0, **kw)
    ev = make_fused_rvae_eval(model, **kw)
    zero_counts()
    per_step, step_ms = [], []
    for i in range(TP_STEPS):  # one call per step, to time the later ones
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        per_step.append(metrics_to_host(step(
            frames_padded, img_idx, coords, idx[i:i + 1].to(device), None, 10.0, 10.0,
            draws=_on(device, draws[i:i + 1]), eps=[eps[i].to(device)])))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    m = {k: sum(d[k] for d in per_step) / TP_STEPS for k in per_step[0]}
    train_launches = counts()
    collective_ms = {}
    if mesh is not None:  # gloo's all-reduce of the STN's and the heads' gathered gradients
        for name, shape in (("stn_input_grad", (2 * BATCH, 32 * (PATCH // 4) ** 2)),
                            ("head_input_grad", (BATCH, 256 * (PATCH // 16) ** 2))):
            buf = torch.zeros(shape, device=device)
            dist.all_reduce(buf, group=mesh.model_group)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(3):
                dist.all_reduce(buf, group=mesh.model_group)
            torch.cuda.synchronize(device)
            collective_ms[name] = {"mb": buf.numel() * 4 / 1e6,
                                   "ms": (time.perf_counter() - t0) / 3 * 1e3}
    trained = {k: v.detach().cpu() for k, v in full_state_dict(model, mesh).items()}
    with torch.no_grad():
        mu = model.encode(probe.to(device))[0].cpu()
    if eval_state is not None:
        load_full_state_dict(model, eval_state, mesh)
    zero_counts()
    em = metrics_to_host(ev(frames_padded, img_idx, coords, vidx.to(device), None, 10.0, 10.0,
                            draws=_on(device, vdraws), eps=[e.to(device) for e in veps]))
    torch.cuda.synchronize(device)
    eval_launches = counts()
    return {"metrics": m, "eval": em, "mu": mu, "state": trained, "step_ms": step_ms,
            "collective_ms": collective_ms, "params": held[:, 0].long().tolist(), "param_bytes": held[:, 1].long().tolist(),
            "train_launches": train_launches, "eval_launches": eval_launches}


def tensor_parallel_phase(ds):
    """Tensor parallelism (livae_tpu_torch.parallel: the split dense layers)
    on the one card: 2 gloo ranks spawned as 1 data x 2 model ways, CUDA
    tensors, the main path's widths in f32 with TF32 off, each rank holding
    all 512 rows; 2 fused train steps with the diversity term (its gather is
    over a data group of one) and one fused eval batch, against the same in
    one process from the same weights, draws and noise: step means within
    1e-5, the gathered weights within 1e-5 but for Adam's near-zero-gradient
    flips (under 0.1 %, within 2 lr per step); the eval, on the one process's
    weights after the steps sliced again onto the ranks (the flipped weights
    alone move the eval's means by 5.4e-5), within 1e-5. Rank 0
    launches rot3 3 / 2 times per step and 3 times per eval batch, and holds
    TP_PARAMS_SAVED fewer parameters than one device; the gathered state
    loads into a plain RVAE whose mu of a probe batch is the split model's
    (within 1e-5)."""
    from livae_tpu_torch.parallel import spawn

    fp, img_idx, coords, margin = ds.device_site_table
    n = len(ds)
    g = torch.Generator().manual_seed(41)
    start = RVAE(LATENT, 1, PATCH, device="cpu", generator=torch.Generator().manual_seed(40))
    state = {k: v.clone() for k, v in start.state_dict().items()}
    idx = torch.randint(0, n, (TP_STEPS, BATCH), generator=g)
    draws = [sample_paired_draws(BATCH, default_transform, g, "cpu") for _ in range(TP_STEPS)]
    eps = [torch.randn((BATCH, LATENT), generator=g) for _ in range(TP_STEPS)]
    vidx = torch.randint(0, n, (1, BATCH), generator=g)
    vdraws = [sample_paired_draws(BATCH, default_transform, g, "cpu")]
    veps = [torch.randn((BATCH, LATENT), generator=g)]
    probe = torch.rand((64, 1, PATCH, PATCH), generator=g)
    args = ((fp.cpu(), img_idx.cpu(), coords.cpu(), margin), idx, draws, eps, vidx, vdraws,
            veps, probe)
    one = _tp_run(None, torch.device("cuda"), state, *args)
    t0 = time.perf_counter()
    split = spawn(_tp_run, 2, state, *args, one["state"], device_type="cuda",
                  backend="gloo", root=tempfile.gettempdir(), model_parallel=2)
    tp_s = time.perf_counter() - t0
    w_max, w_share = _weights_diff(split["state"], one["state"])
    m_diff = _metrics_diff(split["metrics"], one["metrics"])
    e_diff = _metrics_diff(split["eval"], one["eval"])
    plain = RVAE(LATENT, 1, PATCH, device="cuda")
    plain.load_state_dict(split["state"], strict=True)
    with torch.no_grad():
        mu_diff = float((plain.encode(probe.cuda())[0].cpu() - split["mu"]).abs().max())
    torch.backends.cudnn.allow_tf32 = True  # the bf16 paths' setting, as the main path left it
    saved = one["params"][0] - split["params"][0]
    print(f"tensor_parallel: 1 data x 2 model gloo ranks on the card, {TP_STEPS} steps f32 "
          f"batch {BATCH} with diversity: step means max rel diff {m_diff:.3e}, eval "
          f"{e_diff:.3e} (tol 1e-5), weights max diff {w_max:.3e}, share beyond 1e-5 "
          f"{w_share:.2e}, mu of the gathered model {mu_diff:.3e}; rank params "
          f"{split['params']} against {one['params'][0]} ({saved} fewer), rank 0 launches "
          f"train {split['train_launches']} eval {split['eval_launches']}; step ms "
          f"{[round(t, 1) for t in split['step_ms']]} (one process "
          f"{[round(t, 1) for t in one['step_ms']]}), gloo all-reduce "
          f"{json.dumps(split['collective_ms'])}; {tp_s:.1f} s")
    check(m_diff <= 1e-5 and e_diff <= 1e-5 and w_share < 1e-3
          and w_max <= 2 * 1e-3 * TP_STEPS, "the split ranks differ from one process")
    check(mu_diff <= 1e-5, f"the gathered state's model encodes {mu_diff} apart")
    check(saved == TP_PARAMS_SAVED and split["params"][0] == split["params"][1],
          f"rank parameters {split['params']} against {one['params'][0]}")
    want_train = launches_of((PAIRED_STEP, TP_STEPS))
    check(split["train_launches"] == want_train and one["train_launches"] == want_train,
          f"rank 0 train launches {split['train_launches']}")
    check(split["eval_launches"] == launches_of((PAIRED_EVAL, 1)),
          f"rank 0 eval launches {split['eval_launches']}")
    launches = {k: split["train_launches"][k] + split["eval_launches"][k] for k in NO_LAUNCH}
    return {"mesh": "1 data x 2 model (gloo, one card)", "steps": TP_STEPS,
            "steps_metrics_max_rel_diff": m_diff, "eval_metrics_max_rel_diff": e_diff,
            "weights_max_diff": w_max, "weights_share_beyond_1e-5": w_share,
            "gathered_mu_max_diff": mu_diff, "params_per_rank": split["params"],
            "param_bytes_per_rank": split["param_bytes"], "params_one_device": one["params"][0],
            "param_bytes_one_device": one["param_bytes"][0], "seconds": tp_s,
            "rank0_step_ms": split["step_ms"], "one_process_step_ms": one["step_ms"],
            "rank0_gloo_all_reduce": split["collective_ms"],
            "train_launches": split["train_launches"], "eval_launches": split["eval_launches"],
            "launches": launches}


def profile_phase():
    """The profilers: `profile_step --path paired vae patch encode stacked
    --steps 2` as a user runs it, in a fresh process (each path's first
    calls, the main path's in the fresh process, then each phase's top 8
    kernels), and `profile_components --reps 3` (every stage's patches/sec,
    each stage warmed up first) in this process. Both print their reports."""
    from livae_tpu_torch.scripts import profile_components

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "livae_tpu_torch.profile_step", "--path",
                           "paired", "vae", "patch", "encode", "stacked", "--steps", "2",
                           "--top", "8"], capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    step_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"profile_step exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    heads = [ln for ln in lines if ln.startswith("== ")]
    check(sum("first calls" in ln for ln in heads) == 5 and len(heads) == 5 + 8,
          f"profile_step printed {heads}")
    for ln in lines[lines.index(heads[0]):]:  # the report, each phase's kernels
        print(f"profile: {ln.rstrip()}")

    t0 = time.perf_counter()
    blob = profile_components.main(["--reps", "3"])
    components_s = time.perf_counter() - t0
    check(len(blob["patches_per_sec"]) == 14
          and all(v > 0 for v in blob["patches_per_sec"].values()), f"profile_components {blob}")
    print("profile: profile_components us/patch " + json.dumps(blob["us_per_patch"]))
    return {"profile_step": {"seconds": step_s, "headers": heads},
            "profile_components": {"seconds": components_s, **blob}}


def exports_phase():
    """The package's import surface on the card: the JAX package's 40 names
    from `livae_tpu_torch`, a model built and run through them."""
    import livae_tpu_torch
    from livae_tpu_torch import RVAE as TopRVAE
    from livae_tpu_torch import compute_psnr, rvae_loss
    from livae_tpu_torch.parallel import DATA_AXIS, spawn  # noqa: F401
    from livae_tpu_torch.train import make_fused_rvae_train_step as top_step

    check(len(livae_tpu_torch.__all__) == 41 and livae_tpu_torch.__version__ == "0.1.0"
          and all(getattr(livae_tpu_torch, n, None) is not None for n in livae_tpu_torch.__all__),
          "the package's names")
    check(TopRVAE is RVAE and top_step is make_fused_rvae_train_step, "re-exported objects")
    model = TopRVAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
                    generator=torch.Generator().manual_seed(5))
    x = torch.rand((8, 1, PATCH, PATCH), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(6))
    zero_counts()
    with torch.no_grad():
        rotated_recon, _, theta, mu, logvar = model(x, generator=torch.Generator(
            device="cuda").manual_seed(7))
        total = rvae_loss(rotated_recon, x, mu, logvar)[0]
    got = counts()
    psnr = compute_psnr(rotated_recon, x)
    # a forward: the STN's rotation and the inverse one, a decoder and a localisation pass
    check(bool(torch.isfinite(total)) and math.isfinite(psnr)
          and got == launches_of((rvae(1, 0, 1, 0, rot3_fwd=2), 1)),
          f"exports: loss {float(total)}, psnr {psnr}, launches {got}")
    print(f"exports: {len(livae_tpu_torch.__all__)} names; RVAE forward on the card, loss "
          f"{float(total):.4f}, psnr {psnr:.2f} dB, launches {got}")
    return {"names": len(livae_tpu_torch.__all__), "launches": got}


def port_bench_phase():
    """python -m livae_tpu_torch.bench in a process of its own: exit code 0 and
    one JSON line on stdout."""
    proc = subprocess.run([sys.executable, "-m", "livae_tpu_torch.bench"], capture_output=True,
                          text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    sys.stderr.write(proc.stderr[-4000:])
    check(proc.returncode == 0, f"bench exited {proc.returncode}: {proc.stdout[-500:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench printed {len(lines)} lines on stdout")
    result = json.loads(lines[0])
    check({"metric", "value", "unit", "vs_baseline", "detail"} <= set(result)
          and "error" not in result, f"bench line {lines[0]}")
    detail = result["detail"]
    check(result["value"] > 0 and detail["train_patches_per_sec_sustained"] > 0
          and detail["encode_patches_per_sec"] > 0 and detail["batch"] == BATCH
          and detail["patch"] == PATCH, f"bench figures {lines[0]}")
    return lines[0]


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")

    seconds = {"build": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    err, ms, bound = timed("kernel", kernel_phase)
    s_err, s_ms, s_bound, s_cases = timed("shear_kernel", shear_kernel_phase)
    up = timed("upconv_kernel", upconv_kernel_phase)
    print("upconv_kernels " + json.dumps({"card": smi, **up}))
    timed("agreement", agreement_phase)
    ds, build_s = timed("bench_dataset", bench_dataset)
    main = timed("main_path", main_path, ds, build_s)
    print("main_path " + json.dumps({"card": smi, **main}))
    peaks = timed("device_peaks", device_peaks_phase)
    print("device_peaks " + json.dumps({"card": smi, **peaks}))
    host_loop = timed("host_loop", host_loop_phase, ds)
    print("host_loop " + json.dumps({"card": smi, **host_loop}))
    exports = timed("exports", exports_phase)
    print("exports " + json.dumps({"card": smi, **exports}))
    parallel = timed("parallel", parallel_phase, ds)
    print("parallel " + json.dumps({"card": smi, **parallel}))
    tensor_parallel = timed("tensor_parallel", tensor_parallel_phase, ds)
    print("tensor_parallel " + json.dumps({"card": smi, **tensor_parallel}))
    rot_launches = timed("rotation", rotation_path_phase)
    exact = timed("exact_resample", exact_train_phase, ds)
    print("exact_resample_path " + json.dumps({"card": smi, **exact}))
    bench, bench_launches = timed("bench_rotate", bench_phase)
    print("bench_rotate " + json.dumps({"card": smi, "us_per_patch": bench}))
    with tempfile.TemporaryDirectory(prefix="livae_smoke_") as tmp:
        rvae_cli = timed("train_rvae", train_rvae_phase, Path(tmp))
        print("train_rvae " + json.dumps({"card": smi, **rvae_cli}))
        vae_cli = timed("train_vae", train_vae_phase, Path(tmp))
        print("train_vae " + json.dumps({"card": smi, **vae_cli}))
        final = Path(tmp) / "rvae" / "rvae_best_final.pt"
        analysis, analysis_ds = timed("analysis", analysis_phase, Path(tmp), final)
        print("analysis " + json.dumps({"card": smi, **analysis}))
        rot_inv = timed("rotation_invariance", rotation_invariance_phase, final, analysis_ds)
        print("rotation_invariance " + json.dumps({"card": smi, **rot_inv}))
        pretrain = timed("pretrain_stn", pretrain_stn_phase, Path(tmp))
        print("pretrain_stn " + json.dumps({"card": smi, **pretrain}))
        sweep = timed("sweep", sweep_phase, Path(tmp), rvae_cli["sites"])
        print("sweep " + json.dumps({"card": smi, **sweep}))
        stacked = timed("stacked", stacked_phase, Path(tmp), rvae_cli["sites"])
        print("stacked " + json.dumps({"card": smi, **stacked}))
        compare = timed("compare", compare_phase, Path(tmp))
        print("compare " + json.dumps({"card": smi, **compare}))
    patches = timed("patch_dataset", patch_dataset_phase)
    print("patch_dataset " + json.dumps({"card": smi, **patches}))
    timed("vae_agreement", vae_agreement_phase)
    print("bench " + timed("bench", port_bench_phase))
    profiles = timed("profile", profile_phase)
    print("profile " + json.dumps({"card": smi, **profiles}))
    print("phase_seconds " + json.dumps({"card": smi, **seconds,
                                         "total": time.perf_counter() - t_start}))
    # kernel C runs on the rotation paths of this slice, not on the paired main path
    shear_launches = {k: rot_launches[k] + bench_launches[k] for k in rot_launches}
    check(shear_launches["shear_fwd"] > 0 and shear_launches["shear_bwd"] > 0,
          "the rotation paths launched no shear kernel")

    # library_ms: no single PyTorch call computes a 3-shear lerp rotation, or
    # shifts each row or column by its own fractional amount with wrap-around
    rot3_src, shear_src = "livae_tpu_torch/ops/csrc/rot3.cu", "livae_tpu_torch/ops/csrc/shear.cu"
    entries = [
        ("rot3_fwd", rot3_src, "livae_tpu/ops/pallas/rot3.py:88", main["launches"], "main",
         err["fwd"], ms["fwd"], ms["fwd_plain"], bound["fwd"]),
        ("rot3_bwd", rot3_src, "livae_tpu/ops/pallas/rot3.py:98", main["launches"], "main",
         err["bwd"], ms["bwd"], ms["bwd_plain"], bound["bwd"]),
        ("shear_fwd", shear_src, "livae_tpu/ops/pallas/shear.py:38", shear_launches, "rotation",
         s_err["fwd"], s_ms["fwd"], s_ms["fwd_plain"], s_bound["fwd"]),
        ("shear_bwd", shear_src, "livae_tpu/ops/pallas/shear.py:124", shear_launches,
         "rotation", s_err["bwd"], s_ms["bwd"], s_ms["bwd_plain"], s_bound["bwd"]),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": path_launches[name], "launches_path": path, "max_abs_err": e, "ms": t,
         "plain_ms": plain, "bound_ms": b, "bound_by": "bytes", "library_ms": None}
        for name, src, replaces, path_launches, path, e, t, plain, b in entries
    ]
    # the upconv kernels: each figure the sum over one decoder pass's four stages or
    # one localisation pass's two blocks (bf16, batch 512). library_ms: no single
    # PyTorch call computes the epilogue (depth-to-space, the edge lines' exact
    # corrections, bias, ReLU) or relu-and-max over four channel groups with its
    # first-wins winner map. stage_ms is the whole fused stage or block, unfused_ms
    # the unfused chain it replaces (upsample, pad, conv, ReLU; conv, pool, ReLU),
    # both through PyTorch's calls
    up_src = "livae_tpu_torch/ops/csrc/upconv.cu"
    for name, replaces in (("upconv_fwd", "livae_tpu/ops/upconv.py:124"),
                           ("upconv_bwd", "livae_tpu/ops/upconv.py:124"),
                           ("phasemax_fwd", "livae_tpu/ops/upconv.py:299"),
                           ("phasemax_bwd", "livae_tpu/ops/upconv.py:299")):
        cases = up["cases"][name]
        total = {k: sum(c[k] for c in cases) for k in ("ms", "plain_ms", "bound_ms",
                                                        "stage_ms", "unfused_ms")}
        kernels.append({"name": name, "route": "cuda", "source": up_src, "replaces": replaces,
                        "launches": main["launches"][name], "launches_path": "main",
                        "max_abs_err": up["err"][name], **total, "bound_by": "bytes",
                        "library_ms": None, "dtype": "bfloat16", "cases": cases})
    by_path = {"main": main["launches"], "rotation": shear_launches,
               "exact_resample": exact["launches"], "train_rvae": rvae_cli["launches"],
               "train_vae": vae_cli["launches"], "patch_dataset": patches["launches"],
               "analysis": analysis["launches"], "rotation_invariance": rot_inv["launches"],
               "pretrain_stn": pretrain["launches"], "device_peaks": peaks["launches"],
               "host_loop": host_loop["launches"], "exports": exports["launches"],
               "parallel_nccl": parallel["launches"],
               "parallel_gloo_rank0": parallel["gloo_launches"],
               "tensor_parallel_rank0": tensor_parallel["launches"],
               **{f"sweep_{name}": run["launches"] for name, run in sweep.items()},
               "stacked": stacked["launches"],
               **{name: run["launches"] for name, run in compare.items()}}
    for k in kernels:  # each driven path's own count, read just after it ran
        k["launches_by_path"] = {path: got[k["name"]] for path, got in by_path.items()}
    for k in kernels[:2]:  # the rot3 launch plan at the main path's canvas
        plan = R.launch_plan(SHAPE[1], k["name"][5:])
        k.update(cluster=plan.cluster, smem_per_block=plan.smem)
        check(k["launches_by_path"]["train_rvae"] > 0, f"train_rvae launched no {k['name']}")
        check(k["launches_by_path"]["tensor_parallel_rank0"] > 0,
              f"the tensor-parallel rank 0 launched no {k['name']}")
    for k in kernels[2:4]:  # kernel C: f32 axis 2 above; every timed case beside it
        d = k["name"][6:]
        k.update(dtype="float32", axis=2, shifts="rotation", cases={
            case: v for case, v in s_cases.items() if case.split()[0] in (d, d + "_nodx")})
    for k in kernels[4:]:
        check(k["launches_by_path"]["train_rvae"] > 0 and k["launches_by_path"]["stacked"] > 0,
              f"train_rvae or the stacked trials launched no {k['name']}")
    check(all(k["launches"] > 0 for k in kernels), "a kernel of its path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
