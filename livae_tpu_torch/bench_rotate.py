"""Rotation microbenchmark (port of scripts/bench_rotate.py).

    python -m livae_tpu_torch.bench_rotate [--batch 512] [--reps 8]
        [--canvases 192 256] [--rotations 128,32 128,64] [--cpu]

Times, at batch `--batch`:

* `shear1_{P}_{dtype}`: one fractional shift (kernel C's forward) along W of
  a [B, P, P] canvas, with deltas U(-40, 40);
* `rot_fwd_{S}_m{margin}_{dtype}`: `rotate_image_fast` (backend "auto") of
  [B, 1, S, S] on a canvas of S + 2 margin;
* `rot_grad_{S}_m{margin}_{dtype}`: its forward and backward to the image
  and the angles, of sum(out ** 2);

in bfloat16 and float32. Each line gives ms per call and us per patch; the
last line is the dict of us per patch under the JAX script's keys. On the
card the times come from CUDA events around `--reps` calls after one
warm-up call; `--cpu` runs the plain versions on the CPU and times them on
the host clock. Without `--cpu` it runs on CUDA or raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .device import resolve_device
from .ops.resample import rotate_image_fast
from .ops.shear import fractional_shift

DTYPES = (torch.bfloat16, torch.float32)


def _timed(name: str, fn, reps: int, batch: int, dev: torch.device) -> float:
    """us per patch of fn(i), over reps calls after one warm-up call."""
    fn(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    us_pp = 1e3 * ms / batch
    print(f"{name:>44}: {ms:8.3f} ms/call  {us_pp:7.2f} us/patch")
    return us_pp


def run(batch: int = 512, reps: int = 8, canvases=(192, 256), rotations=((128, 32), (128, 64)),
        device=None) -> dict[str, float]:
    """Run the benchmark; returns {key: us per patch}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    results = {}

    for P in canvases:
        for dtype in DTYPES:
            name = str(dtype).split(".")[-1]
            x = torch.from_numpy(rng.random((batch, P, P), np.float32)).to(dev, dtype)
            d = torch.from_numpy(rng.uniform(-40, 40, (batch, P)).astype(np.float32)).to(dev)
            results[f"shear1_{P}_{name}"] = _timed(
                f"1 shear call canvas {P} {name}",
                lambda i, x=x, d=d: fractional_shift(x, d + i, 2), reps, batch, dev)

    for S, margin in rotations:
        for dtype in DTYPES:
            name = str(dtype).split(".")[-1]
            img = torch.from_numpy(rng.random((batch, 1, S, S), np.float32)).to(dev, dtype)
            th = torch.from_numpy(rng.uniform(-np.pi, np.pi, batch).astype(np.float32)).to(dev)

            def rot_fwd(i, img=img, th=th):
                return rotate_image_fast(img, th + 0.001 * i, "reflection", margin=margin)

            def rot_grad(i, img=img, th=th):
                im = img.detach().requires_grad_(True)
                t = (th + 0.001 * i).requires_grad_(True)
                out = rotate_image_fast(im, t, "reflection", margin=margin)
                return torch.autograd.grad(out.float().square().sum(), (im, t))

            results[f"rot_fwd_{S}_m{margin}_{name}"] = _timed(
                f"rot fwd S={S} margin={margin} {name}", rot_fwd, reps, batch, dev)
            results[f"rot_grad_{S}_m{margin}_{name}"] = _timed(
                f"rot fwd+bwd S={S} margin={margin} {name}", rot_grad, reps, batch, dev)

    return results


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--canvases", type=int, nargs="+", default=[192, 256])
    p.add_argument(
        "--rotations",
        type=lambda s: tuple(int(v) for v in s.split(",")),
        nargs="+",
        default=[(128, 32), (128, 64)],
        help="S,margin pairs",
    )
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = p.parse_args(argv)
    results = run(args.batch, args.reps, args.canvases, args.rotations,
                  device="cpu" if args.cpu else None)
    print({k: round(v, 2) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
