"""Kernel C (ops/csrc/shear.cu) against an earlier shear.cu, on one NVIDIA GPU.

    python -m livae_tpu_torch.diag_shear [--parent-source DIR] [--sweep] [--shape B H W]

At [512, 256, 256] (or --shape), in float32 and bfloat16, along both axes, with the shifts
of real rotations and random shifts, times the forward and the backward (with
dx) as planned by `launch_plan`, and a copy_ of the same bytes.

`--parent-source DIR` also builds the shear.cu of DIR (with its lerp.cuh; the
one-output-per-thread design whose entry points take no plan) and times the
two in turns, parent, current, current, parent, so that the card's drift
falls on both alike. Unpack one with `git archive <commit>
livae_tpu_torch/ops/csrc | tar -x -C _chipcheck/parent` (git ignores
`_chipcheck/`).

`--sweep` also times every tiled plan that fits: axis 2 with 4 to 64 rows per
tile, axis 1 with strips of 8 to 128 columns, and the direct variant.

Times are medians over 7 CUDA-event windows of 10 back-to-back launches.
Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from .diag_rot3 import _ms
from .ops import _build
from .ops import shear as SH

SHAPE = (512, 256, 256)
_OUT = _build.BUILD_DIR / "diag_shear"


def _parent_lib(parent: Path) -> ctypes.CDLL:
    d = _OUT / "parent"
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(parent / "shear.cu", d)
    shutil.copy(parent / "lerp.cuh", d)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                           str(d / "shear.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the parent shear.cu failed to build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.livae_shear_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.livae_shear_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    return lib


def _delta(kind: str, axis: int, gen, shape) -> torch.Tensor:
    """[B, n] shifts (n = H for axis 2, W for axis 1): a real rotation's
    (|phi| <= pi/4, d_row for axis 2 and d_col for axis 1) or uniform random
    ones."""
    B, P = shape[0], shape[1 if axis == 2 else 2]
    if kind == "random":
        return (torch.rand((B, P), device="cuda", generator=gen) - 0.5) * 106.0
    phi = (torch.rand(B, device="cuda", generator=gen) - 0.5) * (torch.pi / 2)
    pos = torch.arange(P, dtype=torch.float32, device="cuda") - (P - 1) / 2.0
    s = -torch.tan(phi / 2) if axis == 2 else torch.sin(phi)
    return (s[:, None] * pos).contiguous()


def _sweep_plans(shape, axis: int, direction: str, dtype) -> list:
    plans = []
    for tile in (4, 8, 16, 32, 64) if axis == 2 else (128, 64, 32, 16, 8):
        try:
            plans.append(SH.launch_plan(*shape, axis, direction, dtype, tile))
        except ValueError:
            pass
    plans.append(SH.ShearPlan(*shape, axis, direction, "direct", 0, 0))
    return plans


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", type=Path, default=None,
                    help="directory with an earlier shear.cu and lerp.cuh to time in turns")
    ap.add_argument("--sweep", action="store_true", help="time every plan that fits")
    ap.add_argument("--shape", type=int, nargs=3, default=list(SHAPE), metavar=("B", "H", "W"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("diag_shear needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    _build.build_all(["shear"])
    parent = _parent_lib(args.parent_source) if args.parent_source else None
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = tuple(args.shape)
    B, H, W = shape
    results = {}

    def run(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        bf = int(dtype == torch.bfloat16)
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        out, dx = torch.empty_like(x), torch.empty_like(x)
        flat = torch.empty(3 * x.numel() // 2, device="cuda", dtype=dtype)
        yflat = torch.empty_like(flat)
        results[f"copy_ {name} fwd bytes"] = _ms(lambda: out.copy_(x))
        results[f"copy_ {name} bwd bytes"] = _ms(lambda: yflat.copy_(flat))
        for axis in (2, 1):
            for kind in ("rotation", "random"):
                delta = _delta(kind, axis, gen, shape)
                dd = torch.empty_like(delta)
                key = f"{name} axis {axis} {kind}"
                new = {"fwd": lambda: SH._launch_fwd(x, delta, axis),
                       "bwd": lambda: SH._launch_bwd(x, delta, g, axis)}
                if parent is None:
                    for k, fn in new.items():
                        results[f"{k} {key}"] = _ms(fn)
                else:
                    ptr = (x.data_ptr(), delta.data_ptr())
                    old = {"fwd": lambda: run(parent.livae_shear_fwd(
                               *ptr, out.data_ptr(), B, H, W, axis, bf, stream)),
                           "bwd": lambda: run(parent.livae_shear_bwd(
                               *ptr, g.data_ptr(), dx.data_ptr(), dd.data_ptr(), B, H, W, axis,
                               bf, stream))}
                    for k in ("fwd", "bwd"):
                        t = [_ms(old[k]), _ms(new[k]), _ms(new[k]), _ms(old[k])]
                        results[f"{k} {key}"] = (t[1] + t[2]) / 2
                        results[f"{k} {key} parent"] = (t[0] + t[3]) / 2
                        print(f"{k} {key}: parent {t[0]:.4f} / {t[3]:.4f} ms, "
                              f"current {t[1]:.4f} / {t[2]:.4f} ms")
                if args.sweep and kind == "rotation":
                    for k in ("fwd", "bwd"):
                        for plan in _sweep_plans(shape, axis, k, dtype):
                            fn = ((lambda: SH._launch_fwd(x, delta, axis, plan)) if k == "fwd"
                                  else (lambda: SH._launch_bwd(x, delta, g, axis, True, plan)))
                            label = f"tile {plan.tile}" if plan.tile else "direct"
                            results[f"sweep {k} {key} {label} {plan.smem} B"] = _ms(fn)
    for key, t in results.items():
        print(f"{key}: {t:.4f} ms")
    return results


if __name__ == "__main__":
    main()
