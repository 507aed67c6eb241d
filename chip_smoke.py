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
     autograd through it (forward and dx bit-equal), also at edge canvases
     [3, P, P] for P in 2, 33, 130, 255 and MAX_P; the dx-free backward gives
     the deltas' bits; times for each cluster size that fits;
   * shear (kernel C), along both axes: the forward against
     `fractional_shift_reference` (bit-equal), the fused backward against
     `fractional_shift_vjp_reference` (dx bit-equal) and against autograd
     through the plain version.
4. Agreement phase: the f32 model on the card (kernels) against the same
   weights on the CPU (plain versions, which tests/test_torch_*.py hold
   against the JAX package) on a small batch.
5. Main path: PairedAdaptiveLatticeDataset on the bench frame, RVAE at patch
   128 / latent 16 / bfloat16, 2 epochs of fused paired training at batch 512
   (AdamW 1e-3, weight decay 1e-5, beta = gamma = 10, canonical weight 0.2,
   clip 20), each followed by the fused eval over 2 val batches, then a fused
   encode. Every train step must launch the rot3 forward 3 times, its
   backward twice, and no shear kernel.
6. Rotation paths: `rotate_image_fast(backend="shear")` against "fused" on
   [512, 1, 128, 128] (canvas 256) in f32 and bf16; a [64, 3, 128, 128]
   rotation under "auto" (kernel C, not rot3); three fused paired train steps
   of `RVAE(fast_resample=False)` at batch 512 in bf16 (rot3 only for the
   augmentation); `python -m livae_tpu_torch.bench_rotate --reps 3`.
Around each driven path the launch counters are zeroed just before and read
just after. The build step prints each kernel's registers and spills (ptxas);
the rot3 phase prints each cluster size's time, shared memory per block,
resident clusters and share of the bound. Then it prints one
{"kernels": [...]} line and, last, the
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

from livae_tpu_torch import bench_rotate
from livae_tpu_torch.data.datasets import PairedAdaptiveLatticeDataset
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
from livae_tpu_torch.models.rvae import RVAE
from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import rot3 as R
from livae_tpu_torch.ops import shear as SH
from livae_tpu_torch.ops.resample import aligned_margin, rotate_image_fast
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
EXACT_STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def zero_counts() -> None:
    R.FWD_LAUNCHES = R.BWD_LAUNCHES = SH.FWD_LAUNCHES = SH.BWD_LAUNCHES = 0


def counts() -> dict[str, int]:
    return {"rot3_fwd": R.FWD_LAUNCHES, "rot3_bwd": R.BWD_LAUNCHES,
            "shear_fwd": SH.FWD_LAUNCHES, "shear_bwd": SH.BWD_LAUNCHES}


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
    shape and at edge canvases; time them at bf16 for each cluster size."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P, _ = SHAPE
    # f32 references in full f32 (no TF32 anywhere in rot3; set for the record)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"fwd": 0.0, "bwd": 0.0}
    for shape in [SHAPE] + [(EDGE_B, p, p) for p in EDGE_P]:
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


def shear_kernel_phase():
    """Hold kernel C's forward and fused backward against the plain versions
    along both axes; time them at bf16 with the shifts of real rotations."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, P, _ = SHAPE
    err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-23
        for axis in (2, 1):
            for kind in ("rotation", "integer", "random"):
                x = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
                g = torch.randn(SHAPE, device=dev, generator=gen).to(dtype)
                d_row, d_col = _deltas(kind, gen, B, P)
                delta = d_row if axis == 2 else d_col
                ins = [t.clone().requires_grad_(True) for t in (x, delta)]
                y = SH.FractionalShiftFunction.apply(*ins, axis)
                dx, dd = torch.autograd.grad(y, ins, g)
                y_ref = SH.fractional_shift_reference(x, delta, axis)
                dx_v, dd_v = SH.fractional_shift_vjp_reference(x, delta, g, axis)
                dx_a, dd_a = torch.autograd.grad(SH.fractional_shift_reference(*ins, axis), ins, g)
                torch.cuda.synchronize()
                fe = (y.float() - y_ref.float()).abs().max().item()
                xe = (dx.float() - dx_v.float()).abs().max().item()
                xa = (dx.float() - dx_a.float()).abs().max().item()
                de = (dd - dd_v).abs().max().item()
                da = (dd - dd_a).abs().max().item()
                # forward and dx: the same f32 operations with no FMA contraction,
                # so bit-equal. dx against autograd: the -delta shift rounds 1 - f
                # once more where |delta| < 1, a few ulps of g. d delta: sums of P
                # products in another order. Autograd's d delta does not round
                # g1 - g0 to bf16 as the JAX formula does, so it is held only in f32.
                tol_a = 4 * ulp * g.float().abs().max().item()
                tol_d = 1e-4 * max(1.0, dd_v.abs().max().item())
                print(f"shear {str(dtype)[6:]:8s} axis {axis} {kind:8s} fwd {fe:.3e} (tol 0) "
                      f"dx {xe:.3e} (tol 0) dx-autograd {xa:.3e} (tol {tol_a:.1e}) "
                      f"d_delta {de:.3e} (tol {tol_d:.1e}) d_delta-autograd {da:.3e}")
                check(fe == 0.0, f"shear forward {dtype} axis {axis} {kind}")
                check(xe == 0.0, f"shear backward dx {dtype} axis {axis} {kind}")
                check(xa <= tol_a, f"shear backward dx vs autograd {dtype} axis {axis} {kind}")
                check(de <= tol_d, f"shear backward d_delta {dtype} axis {axis} {kind}")
                if dtype == torch.float32:
                    check(da <= tol_d, f"shear d_delta vs autograd axis {axis} {kind}")
                err["fwd"] = max(err["fwd"], fe)
                err["bwd"] = max(err["bwd"], xe, de)

    x = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    g = torch.randn(SHAPE, device=dev, generator=gen).bfloat16()
    ms = {}
    for kind in ("random", "rotation"):
        d_row, d_col = _deltas(kind, gen, B, P)
        for axis, delta in ((1, d_col), (2, d_row)):
            ms["fwd"] = median_ms(lambda: SH._launch_fwd(x, delta, axis))
            ms["bwd"] = median_ms(lambda: SH._launch_bwd(x, delta, g, axis))
            print(f"shear kernels, bf16 {list(SHAPE)}, axis {axis}, {kind} shifts: forward "
                  f"{ms['fwd']:.4f} ms, backward {ms['bwd']:.4f} ms")
    # the line's figures: axis 2 with the shifts of real rotations (the last pair)
    ms["fwd_plain"] = median_ms(lambda: SH.fractional_shift_reference(x, delta, 2), reps=3)
    ms["bwd_plain"] = median_ms(
        lambda: SH.fractional_shift_vjp_reference(x, delta, g, 2), reps=3)

    n, io, dl = B * P * P, x.element_size(), 4 * B * P
    bound = {
        "fwd": max((2 * n * io + dl) / HBM_BYTES_PER_S, 4 * n / F32_FLOP_PER_S) * 1e3,
        "bwd": max((3 * n * io + 2 * dl) / HBM_BYTES_PER_S, 7 * n / F32_FLOP_PER_S) * 1e3,
    }
    for k in ("fwd", "bwd"):
        print(f"shear_{k} bf16 {list(SHAPE)} axis 2: kernel {ms[k]:.4f} ms, plain "
              f"{ms[k + '_plain']:.4f} ms, bound {bound[k]:.4f} ms (bytes)")
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
    launches = counts()
    m = ENCODE_STEPS * BATCH
    check(tuple(mu.shape) == (m, LATENT) and tuple(logvar.shape) == (m, LATENT)
          and tuple(theta.shape) == (m, 1), "encode shapes")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(logvar).all()
               and torch.isfinite(theta).all()), "encode outputs not finite")
    steps = EPOCHS * STEPS_PER_EPOCH
    check(launches["rot3_fwd"] == 3 * steps + 3 * EPOCHS * VAL_BATCHES + 2 * ENCODE_STEPS
          and launches["rot3_bwd"] == 2 * steps
          and launches["shear_fwd"] == launches["shear_bwd"] == 0,
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
            want = ({"rot3_fwd": 1, "rot3_bwd": 1, "shear_fwd": 0, "shear_bwd": 0}
                    if backend == "fused" else
                    {"rot3_fwd": 0, "rot3_bwd": 0, "shear_fwd": 3, "shear_bwd": 3})
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
    check(got == {"rot3_fwd": EXACT_STEPS, "rot3_bwd": 0, "shear_fwd": 0, "shear_bwd": 0},
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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")

    err, ms, bound = kernel_phase()
    s_err, s_ms, s_bound = shear_kernel_phase()
    agreement_phase()
    ds, build_s = bench_dataset()
    main = main_path(ds, build_s)
    print("main_path " + json.dumps({"card": smi, **main}))
    rot_launches = rotation_path_phase()
    exact = exact_train_phase(ds)
    print("exact_resample_path " + json.dumps({"card": smi, **exact}))
    bench, bench_launches = bench_phase()
    print("bench_rotate " + json.dumps({"card": smi, "us_per_patch": bench}))
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
    for k in kernels[:2]:  # the rot3 launch plan at the main path's canvas
        plan = R.launch_plan(SHAPE[1], k["name"][5:])
        k.update(cluster=plan.cluster, smem_per_block=plan.smem)
    check(all(k["launches"] > 0 for k in kernels), "a kernel of its path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
