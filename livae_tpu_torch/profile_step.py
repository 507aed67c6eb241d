"""Where the port's main path spends device time, on one NVIDIA GPU.

    python -m livae_tpu_torch.profile_step [--steps 3] [--top 30] [--trace PATH]

Builds the main path of chip_smoke.py (bench frame, RVAE patch 128 / latent
16 / bfloat16, batch 512, AdamW), warms it up, then runs `--steps` fused
train steps, one eval batch and one encode batch under torch.profiler. For
each phase it prints the wall time, the device-busy share (summed kernel
time over wall time) and the kernels with the most device time, with their
launch counts. `--trace` also writes a Chrome trace of the train phase.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .data.datasets import PairedAdaptiveLatticeDataset
from .data.synthetic import synthetic_mos2_frame
from .models.rvae import RVAE
from .train.engine import (
    make_fused_encode,
    make_fused_rvae_eval,
    make_fused_rvae_train_step,
    metrics_to_host,
)
from .train.state import make_optimizer

PATCH, LATENT, BATCH, PADDING = 128, 16, 512, 32


def _kernel_table(prof) -> dict[str, list]:
    """name -> [device microseconds, launches] over the profiled kernels."""
    table: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            table[ev.name][0] += ev.time_range.elapsed_us()
            table[ev.name][1] += 1
    return table


def _report(phase: str, wall_s: float, prof, top: int) -> None:
    table = _kernel_table(prof)
    busy_us = sum(v[0] for v in table.values())
    launches = sum(v[1] for v in table.values())
    print(f"== {phase}: wall {wall_s * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / 1e6 / wall_s:.1f} %), {launches} kernel launches")
    for name, (us, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f} % {n:6d}x  {name[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frame, _ = synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)
    ds = PairedAdaptiveLatticeDataset([frame], patch_size=PATCH, padding=PADDING, device="cuda")
    model = RVAE(LATENT, 1, PATCH, "bfloat16", device="cuda",
                 generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model.parameters(), 1e-3, optimizer="adamw", weight_decay=1e-5)
    fp, img_idx, coords, margin = ds.device_site_table
    kw = dict(patch_size=PATCH, padding=PADDING, margin=margin)
    step = make_fused_rvae_train_step(model, opt, cfg=ds.transform, canonical_weight=0.2,
                                      grad_max_norm=20.0, **kw)
    evaluate = make_fused_rvae_eval(model, cfg=ds.transform, canonical_weight=0.2, **kw)
    encode = make_fused_encode(model, **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batches(s):
        return torch.randint(0, len(ds), (s, BATCH), generator=gen, device="cuda")

    phases = {
        "train": (lambda idx: metrics_to_host(step(fp, img_idx, coords, idx, gen, 10.0, 10.0)),
                  args.steps),
        "eval": (lambda idx: metrics_to_host(evaluate(fp, img_idx, coords, idx, gen, 10.0, 10.0)),
                 1),
        "encode": (lambda idx: encode(fp, img_idx, coords, idx)[0].sum().item(), 1),
    }
    for fn, s in phases.values():  # warm-up: allocator, cuDNN plans, kernel build
        fn(batches(s))
    torch.cuda.synchronize()
    for phase, (fn, s) in phases.items():
        idx = batches(s)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(f"{phase} ({s} x batch {BATCH})", wall, prof, args.top)
        if phase == "train" and args.trace:
            prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
