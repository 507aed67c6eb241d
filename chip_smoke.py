#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (livae_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from ops/csrc with nvcc, one process per source.
3. Kernel phase: holds the rot3 forward and backward kernels against the
   plain PyTorch version (`rot3_reference` and autograd through it) at the
   main path's shape [512, 256, 256], in bfloat16 and float32, with the
   shifts of real rotations, integer shifts and random shifts, and times
   kernel and plain version with CUDA events.
4. Agreement phase: the f32 model on the card (kernels) against the same
   weights on the CPU (plain versions, which tests/test_torch_*.py hold
   against the JAX package) on a small batch.
5. Main path: PairedAdaptiveLatticeDataset on the bench frame, RVAE at patch
   128 / latent 16 / bfloat16, 2 epochs of fused paired training at batch 512
   (AdamW 1e-3, weight decay 1e-5, beta = gamma = 10, canonical weight 0.2,
   clip 20), each followed by the fused eval over 2 val batches, then a fused
   encode. Launch counters are zeroed just before and read just after; every
   train step must launch the forward kernel 3 times and the backward twice.
6. Prints one {"kernels": [...]} line and, last, the
   {"ok": true, "device": {...}} line.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without CUDA or without the package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from livae_tpu_torch.data.datasets import PairedAdaptiveLatticeDataset
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import rot3 as R
from livae_tpu_torch.train.engine import (
    make_fused_encode,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    metrics_to_host,
)
from livae_tpu_torch.train.state import make_optimizer

SHAPE = (512, 256, 256)  # rot3's canvas on the main path at batch 512, patch 128
PATCH, LATENT, BATCH, PADDING = 128, 16, 512, 32
STEPS_PER_EPOCH, EPOCHS, VAL_BATCHES, ENCODE_STEPS = 6, 2, 2, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event-timed calls of fn, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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


def kernel_phase():
    """Hold both rot3 kernels against the plain version; time them at bf16."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P, _ = SHAPE
    # f32 references in full f32 (no TF32 anywhere in rot3; set for the record)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("rotation", "integer", "random"):
            x = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
            w = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
            d_row, d_col = _deltas(kind, gen, B, P)
            y = R.Rot3Function.apply(x, d_row, d_col)
            y_ref = R.rot3_reference(x, d_row, d_col)
            ins = [t.clone().requires_grad_(True) for t in (x, d_row, d_col)]
            gk = torch.autograd.grad(R.Rot3Function.apply(*ins), ins, w)
            gr = torch.autograd.grad(R.rot3_reference(*ins), ins, w)
            torch.cuda.synchronize()
            fe = (y.float() - y_ref.float()).abs().max().item()
            ge = [(a.float() - b.float()).abs().max().item() for a, b in zip(gk, gr)]
            scale = [b.float().abs().max().item() for b in gr]
            # forward and dx: the same f32 operations with no FMA contraction,
            # so bit-equal is expected; the tolerance allows one ulp of the
            # I/O type. d_row/d_col: sums of P products in another order.
            ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-23
            tol_y = ulp * y_ref.float().abs().max().item()
            tol_x = ulp * scale[0]
            tol_d = [1e-4 * max(1.0, s) for s in scale[1:]]
            print(f"rot3 {str(dtype)[6:]:8s} {kind:8s} fwd max_abs_err {fe:.3e} (tol {tol_y:.1e}) "
                  f"dx {ge[0]:.3e} (tol {tol_x:.1e}) d_row {ge[1]:.3e} (tol {tol_d[0]:.1e}) "
                  f"d_col {ge[2]:.3e} (tol {tol_d[1]:.1e})")
            check(fe <= tol_y, f"rot3 forward {dtype} {kind}")
            check(ge[0] <= tol_x, f"rot3 backward dx {dtype} {kind}")
            check(ge[1] <= tol_d[0] and ge[2] <= tol_d[1], f"rot3 backward deltas {dtype} {kind}")
            err["fwd"] = max(err["fwd"], fe)
            err["bwd"] = max(err["bwd"], *ge)

    # times at the main path's dtype, with the shifts of real rotations (the
    # kernels' reads depend on them); the random shifts are timed for the record
    x = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    g = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    ms = {}
    for kind in ("random", "rotation"):
        d_row, d_col = _deltas(kind, gen, B, P)
        ms["fwd"] = median_ms(lambda: R._launch_fwd(x, d_row, d_col))
        ms["bwd"] = median_ms(lambda: R._launch_bwd(x, d_row, d_col, g))
        print(f"rot3 kernels, bf16 {list(SHAPE)}, {kind} shifts: forward {ms['fwd']:.4f} ms,"
              f" backward {ms['bwd']:.4f} ms")
    ms["fwd_plain"] = median_ms(lambda: R.rot3_reference(x, d_row, d_col), reps=10)
    ins = [t.clone().requires_grad_(True) for t in (x, d_row, d_col)]
    y_ref = R.rot3_reference(*ins)
    ms["bwd_plain"] = median_ms(
        lambda: torch.autograd.grad(y_ref, ins, g, retain_graph=True), reps=10)

    n, io, dl = B * P * P, x.element_size(), 4 * B * P
    bound = {
        "fwd": max((2 * n * io + 2 * dl) / HBM_BYTES_PER_S, 12 * n / F32_FLOP_PER_S) * 1e3,
        "bwd": max((3 * n * io + 4 * dl) / HBM_BYTES_PER_S, 29 * n / F32_FLOP_PER_S) * 1e3,
    }
    for k in ("fwd", "bwd"):
        print(f"rot3_{k} bf16 {list(SHAPE)}: kernel {ms[k]:.4f} ms, plain {ms[k + '_plain']:.4f} ms,"
              f" bound {bound[k]:.4f} ms (bytes)")
    return err, ms, bound


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


def main_path():
    # Main path: the convolutions run in bfloat16 (TF32 does not apply); the
    # float32 dense layers run in full float32 (matmul TF32 off, the default).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    frame, _ = synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)
    ds = PairedAdaptiveLatticeDataset([frame], patch_size=PATCH, padding=PADDING, device="cuda")
    build_s = time.perf_counter() - t0
    n = len(ds)
    check(n == 1409, f"site table has {n} sites, the bench frame gives 1409")
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

    R.FWD_LAUNCHES = R.BWD_LAUNCHES = 0
    epochs = []
    for e in range(EPOCHS):
        idx = torch.randint(0, n, (STEPS_PER_EPOCH, BATCH), generator=gen, device="cuda")
        vidx = torch.randint(0, n, (VAL_BATCHES, BATCH), generator=gen, device="cuda")
        f0, b0 = R.FWD_LAUNCHES, R.BWD_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tm = metrics_to_host(step(frames_padded, img_idx, coords, idx, gen, 10.0, 10.0))
        t1 = time.perf_counter()
        f1, b1 = R.FWD_LAUNCHES, R.BWD_LAUNCHES
        vm = metrics_to_host(evaluate(frames_padded, img_idx, coords, vidx, gen, 10.0, 10.0))
        t2 = time.perf_counter()
        check(f1 - f0 == 3 * STEPS_PER_EPOCH and b1 - b0 == 2 * STEPS_PER_EPOCH,
              f"train launches fwd {f1 - f0} bwd {b1 - b0} for {STEPS_PER_EPOCH} steps")
        check(R.FWD_LAUNCHES - f1 == 3 * VAL_BATCHES and R.BWD_LAUNCHES == b1,
              "eval launches")
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
    launches = {"fwd": R.FWD_LAUNCHES, "bwd": R.BWD_LAUNCHES}
    m = ENCODE_STEPS * BATCH
    check(tuple(mu.shape) == (m, LATENT) and tuple(logvar.shape) == (m, LATENT)
          and tuple(theta.shape) == (m, 1), "encode shapes")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(logvar).all()
               and torch.isfinite(theta).all()), "encode outputs not finite")
    steps = EPOCHS * STEPS_PER_EPOCH
    check(launches["fwd"] == 3 * steps + 3 * EPOCHS * VAL_BATCHES + 2 * ENCODE_STEPS
          and launches["bwd"] == 2 * steps, f"main path launches {launches}")

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


def main() -> int:
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    err, ms, bound = kernel_phase()
    agreement_phase()
    main = main_path()
    print("main_path " + json.dumps({"card": smi, **main}))

    source = "livae_tpu_torch/ops/csrc/rot3.cu"
    kernels = [
        {"name": "rot3_fwd", "route": "cuda", "source": source,
         "replaces": "livae_tpu/ops/pallas/rot3.py:88", "launches": main["launches"]["fwd"],
         "max_abs_err": err["fwd"], "ms": ms["fwd"], "plain_ms": ms["fwd_plain"],
         "bound_ms": bound["fwd"], "bound_by": "bytes", "library_ms": None},
        {"name": "rot3_bwd", "route": "cuda", "source": source,
         "replaces": "livae_tpu/ops/pallas/rot3.py:98", "launches": main["launches"]["bwd"],
         "max_abs_err": err["bwd"], "ms": ms["bwd"], "plain_ms": ms["bwd_plain"],
         "bound_ms": bound["bwd"], "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
