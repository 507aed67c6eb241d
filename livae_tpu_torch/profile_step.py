"""Where the port's paths spend their time, on one NVIDIA GPU (or the CPU).

    python -m livae_tpu_torch.profile_step [--path paired vae patch encode stacked]
        [--steps 3] [--top 30] [--trace PATH] [--cpu] [size flags]

Each `--path` (default `paired`) is built at the production shapes (bench
frame of 1024 pixels, patch 128, padding 32, latent 16, batch 512, bfloat16
on the card, float32 on the CPU) and profiled:

* paired: the main path, `--steps` fused paired rVAE train steps, one eval
  batch and one encode batch (the bench's phases);
* vae: `--steps` fused steps of the plain VAE (Adam, clip 5) on the bench
  frame's AdaptiveLatticeDataset, and one eval batch;
* patch: `--steps` fused VAE steps on PatchDataset (its augmentation rotates
  each batch: one rot3 forward per step);
* encode: the analysis encode, one batch of 256 (the analysis scripts'
  default) through `visualizations.collect_stats`' forward in float32 at
  padding 16;
* stacked: `--steps` stacked steps of 4 rVAE lanes under the VAE loss
  (sweep.stacked, one vmapped program).

For each path it first prints the wall time of each phase's first call in
this process (for the first path: in a fresh process, after the kernel
build), then warms up, then runs each phase under torch.profiler: the wall
time, the device-busy share (summed kernel time over wall time) and the
kernels with the most device time with their launch counts; on the CPU, the
operators with the most self time instead. `--trace` writes a Chrome trace
of the first path's first phase.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.datasets import AdaptiveLatticeDataset, PairedAdaptiveLatticeDataset, PatchDataset
from .data.synthetic import synthetic_mos2_frame
from .device import resolve_device
from .models.rvae import RVAE
from .models.vae import VAE
from .scripts._common import card_description, prebuild_kernels, sync
from .sweep.stacked import StackedState, make_stacked_fns
from .train.engine import (
    make_fused_encode,
    make_fused_eval,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    make_fused_vae_train_step,
    metrics_to_host,
)
from .train.state import make_optimizer

PATHS = ("paired", "vae", "patch", "encode", "stacked")
ENCODE_BATCH, LANES = 256, 4


def _kernel_table(prof) -> dict[str, list]:
    """name -> [device microseconds, launches] over the profiled kernels."""
    table: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            table[ev.name][0] += ev.time_range.elapsed_us()
            table[ev.name][1] += 1
    return table


def _report(phase: str, wall_s: float, prof, top: int, device: torch.device) -> None:
    if device.type != "cuda":  # no kernels: the operators by self time
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        total = sum(e.self_cpu_time_total for e in ops) or 1.0
        print(f"== {phase}: wall {wall_s * 1e3:.3f} ms, {len(ops)} operators (host self time)")
        for e in ops[:top]:
            print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms "
                  f"{100 * e.self_cpu_time_total / total:5.1f} % {e.count:6d}x  {e.key[:110]}")
        return
    table = _kernel_table(prof)
    busy_us = sum(v[0] for v in table.values())
    launches = sum(v[1] for v in table.values())
    print(f"== {phase}: wall {wall_s * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / 1e6 / wall_s:.1f} %), {launches} kernel launches")
    for name, (us, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy_us, 1e-9):5.1f} % {n:6d}x  "
              f"{name[:110]}")


def _frame(args) -> np.ndarray:
    return synthetic_mos2_frame(size=args.frame_size, spacing=40.0, seed=0)[0]


def _paired(args, device, dtype, gen):
    ds = PairedAdaptiveLatticeDataset([_frame(args)], patch_size=args.patch,
                                      padding=args.padding, device=device)
    model = RVAE(args.latent_dim, 1, args.patch, dtype, device=device,
                 generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    fp, img_idx, coords, margin = ds.device_site_table
    kw = dict(patch_size=args.patch, padding=args.padding, margin=margin, device=device)
    step = make_fused_rvae_train_step(model, opt, cfg=ds.transform, canonical_weight=0.2,
                                      grad_max_norm=20.0, **kw)
    evaluate = make_fused_rvae_eval(model, cfg=ds.transform, canonical_weight=0.2, **kw)
    encode = make_fused_encode(model, **kw)
    idx = _index_batches(len(ds), args.batch, gen, device)
    return {
        "train": (lambda: idx(args.steps),
                  lambda i: metrics_to_host(step(fp, img_idx, coords, i, gen, 10.0, 10.0)),
                  f"{args.steps} x batch {args.batch}"),
        "eval": (lambda: idx(1),
                 lambda i: metrics_to_host(evaluate(fp, img_idx, coords, i, gen, 10.0, 10.0)),
                 f"1 x batch {args.batch}"),
        "encode": (lambda: idx(1), lambda i: encode(fp, img_idx, coords, i)[0].sum().item(),
                   f"1 x batch {args.batch}"),
    }


def _index_batches(n: int, batch: int, gen, device):
    return lambda s: torch.randint(0, n, (s, batch), generator=gen, device=device)


def _vae_phases(args, device, dtype, gen, ds, normalize: bool, with_eval: bool):
    model = VAE(args.latent_dim, 1, args.patch, dtype, device=device,
                generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model, 1e-3, optimizer="adam")
    fp, img_idx, coords, margin = ds.device_site_table
    kw = dict(patch_size=args.patch, padding=ds.padding, margin=margin, normalize=normalize,
              device=device)
    step = make_fused_vae_train_step(model, opt, cfg=ds.transform, grad_max_norm=5.0, **kw)
    idx = _index_batches(len(ds), args.batch, gen, device)
    phases = {"train": (lambda: idx(args.steps),
                        lambda i: metrics_to_host(step(fp, img_idx, coords, i, gen, 1.0, 0.0)),
                        f"{args.steps} x batch {args.batch}")}
    if with_eval:
        evaluate = make_fused_eval(model, **kw)
        phases["eval"] = (lambda: idx(1),
                          lambda i: metrics_to_host(evaluate(fp, img_idx, coords, i, gen, 1.0,
                                                             0.0)),
                          f"1 x batch {args.batch}")
    return phases


def _vae(args, device, dtype, gen):
    ds = AdaptiveLatticeDataset([_frame(args)], patch_size=args.patch, padding=args.padding,
                                device=device)
    return _vae_phases(args, device, dtype, gen, ds, normalize=True, with_eval=True)


def _patch(args, device, dtype, gen):
    ds = PatchDataset([_frame(args)], patch_size=args.patch, device=device)
    return _vae_phases(args, device, dtype, gen, ds, normalize=False, with_eval=False)


def _encode(args, device, dtype, gen):
    from .scripts.visualizations import _batch_stats

    # the analysis scripts' dataset and model: no augmentation, padding 16, float32
    ds = AdaptiveLatticeDataset([_frame(args)], patch_size=args.patch, padding=16,
                                transform=None, device=device)
    model = RVAE(args.latent_dim, 1, args.patch, device=device,
                 generator=torch.Generator().manual_seed(1)).eval()
    n = min(ENCODE_BATCH, len(ds))

    @torch.no_grad()
    def run(chunk):
        mu, logvar, err = _batch_stats(model, ds.batch_at(chunk), True,
                                       generator=torch.Generator(device=device).manual_seed(0))
        return err.sum().item()

    return {"encode": (lambda: np.arange(n), run, f"1 x batch {n}")}


def _stacked(args, device, dtype, gen):
    ds = AdaptiveLatticeDataset([_frame(args)], patch_size=args.patch, padding=args.padding,
                                device=device)
    models = [RVAE(args.latent_dim, 1, args.patch, dtype, device=device,
                   generator=torch.Generator().manual_seed(k)) for k in range(LANES)]
    fp, img_idx, coords, margin = ds.device_site_table
    step, _ = make_stacked_fns(models[0], patch_size=args.patch, padding=args.padding,
                               cfg=ds.transform, margin=margin, grad_max_norm=20.0,
                               device=device)
    state = StackedState.create(models)
    del models
    K = LANES
    gens = [torch.Generator(device=device).manual_seed(10 + k) for k in range(K)]
    betas, gammas = [1.0] * K, [0.0] * K

    def run(i):
        _, metrics = step(state, fp, img_idx, coords, i, gens, betas, gammas)
        return metrics_to_host(metrics)

    return {"train": (lambda: torch.randint(0, len(ds), (K, args.steps, args.batch),
                                            generator=gen, device=device),
                      run, f"{K} lanes x {args.steps} x batch {args.batch}")}


SETUPS = {"paired": _paired, "vae": _vae, "patch": _patch, "encode": _encode,
          "stacked": _stacked}


def _timed(fn, arg, device) -> float:
    sync(device)
    t0 = time.perf_counter()
    fn(arg)
    sync(device)
    return time.perf_counter() - t0


def profile_path(path: str, args, device: torch.device, trace: str | None = None) -> dict:
    """Build `path`, time each phase's first call, warm up, then profile each
    phase once. Returns {"first_call_ms": {phase: ms}, "wall_ms": {phase: ms}}."""
    dtype = "bfloat16" if device.type == "cuda" else None
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    phases = SETUPS[path](args, device, dtype, gen)
    setup_s = time.perf_counter() - t0
    first = {name: 1e3 * _timed(run, make(), device) for name, (make, run, _) in phases.items()}
    print(f"== {path} first calls in this process: "
          + ", ".join(f"{name} {ms:.1f} ms" for name, ms in first.items())
          + f" (set-up {setup_s:.2f} s)", flush=True)
    for make, run, _ in phases.values():  # warm-up: allocator, cuDNN plans
        run(make())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    wall = {}
    for name, (make, run, label) in phases.items():
        arg = make()
        sync(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(arg)
            sync(device)
            wall[name] = time.perf_counter() - t0
        _report(f"{path} {name} ({label})", wall[name], prof, args.top, device)
        if trace:
            prof.export_chrome_trace(trace)
            trace = None
    return {"first_call_ms": first, "wall_ms": {k: 1e3 * v for k, v in wall.items()}}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", nargs="+", choices=PATHS, default=["paired"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cpu", action="store_true", help="Profile the plain versions on the CPU")
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--padding", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--frame-size", type=int, default=1024)
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    print(card_description(device), flush=True)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    prebuild_kernels(device)
    out = {}
    for path in args.path:
        out[path] = profile_path(path, args, device, args.trace if not out else None)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
