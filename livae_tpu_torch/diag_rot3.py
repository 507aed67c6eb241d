"""Where the rot3 cluster kernels spend their time, on one NVIDIA GPU.

    python -m livae_tpu_torch.diag_rot3 [--parent-source DIR]

Builds variants of ops/csrc/rot3.cu, each with one part of the work taken
out, and times them beside the kernels as they are, at bf16 [512, 256, 256]
with the shifts of real rotations, for each cluster size that fits:

* `kernel`: the source as it is;
* `local_rows`: every entry of the row table points into the block's own
  band, so no access crosses the cluster's network (the results are wrong;
  only the time is read);
* `fwd_phase1_only`: the forward without its phase 2 (no column stage, no
  output row, no output store);
* `fwd_setup_only`: the forward with neither phase: the launch, the shift
  tables, the first group of row loads and the cluster syncs;
* `fwd_timeline`: the forward as it is, with each block's thread 0 writing
  the global timer at its phase boundaries; the script prints each phase's
  mean, median and 90th percentile over the blocks, the mean number of
  blocks alive, and how many SMs ran blocks.

`--parent-source DIR` also builds an earlier rot3.cu from DIR (with its
lerp.cuh; the one-block-per-sample design with device-memory scratch, whose
entry points take a scratch pointer) and times it in the same process.

Times are medians over 7 CUDA-event windows of 10 back-to-back launches.
Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from .ops import _build
from .ops import rot3 as R

B, P = 512, 256
_OUT = _build.BUILD_DIR / "diag"

VARIANTS = {
    "kernel": [],
    "local_rows": [(
        "t.rows[i] = home + static_cast<long>(i - owner * R) * P;",
        "t.rows[i] = band + static_cast<long>(i % R) * P; (void)home;",
    )],
    "fwd_phase1_only": [(
        "  T* os = out + b * PP;\n  for (int y = y0 + warp; y < y1; y += kWarps) {",
        "  T* os = out + b * PP;\n  for (int y = y1; y < y1; y += kWarps) {",
    )],
    # timestamps (%globaltimer) of each block at its phase boundaries, and its SM
    "fwd_timeline": [(
        "namespace cg = cooperative_groups;\n",
        "namespace cg = cooperative_groups;\n"
        "__device__ unsigned long long g_times[65536 * 8];\n"
        "__device__ __forceinline__ void stamp(int k) {\n"
        "  unsigned long long v;\n"
        "  if (k == 7) { unsigned id; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(id)); v = id; }\n"
        "  else asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v));\n"
        "  if (threadIdx.x == 0) g_times[blockIdx.x * 8 + k] = v;\n"
        "}\n",
    ), (
        "  const T* xs = x + b * PP;\n  Group<T, kC> grp;",
        "  stamp(0); stamp(7);\n  const T* xs = x + b * PP;\n  Group<T, kC> grp;",
    ), (
        "  __syncthreads();  // the tables are written\n  cluster_barrier();  // every block of the cluster runs before any stores to it\n\n  // phase 1: a = Sx(x)",
        "  __syncthreads();  // the tables are written\n  stamp(1);\n  cluster_barrier();  // every block of the cluster runs before any stores to it\n  stamp(2);\n\n  // phase 1: a = Sx(x)",
    ), (
        "           [&](int r) { shift_push_row(t, row, r, P, lane); });\n  cluster.sync();\n\n  // phase 2: row y",
        "           [&](int r) { shift_push_row(t, row, r, P, lane); });\n  __syncthreads();\n  stamp(3);\n  cluster.sync();\n  stamp(4);\n\n  // phase 2: row y",
    ), (
        "  cluster_barrier();  // no block leaves while another still reads its band\n}",
        "  __syncthreads();\n  stamp(5);\n  cluster_barrier();  // no block leaves while another still reads its band\n  stamp(6);\n}",
    ), (
        'extern "C" {\n',
        'extern "C" {\n\nint livae_rot3_times(void* dst, long bytes) {\n'
        '  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_times, bytes));\n}\n',
    )],
    "fwd_setup_only": [(
        "  T* os = out + b * PP;\n  for (int y = y0 + warp; y < y1; y += kWarps) {",
        "  T* os = out + b * PP;\n  for (int y = y1; y < y1; y += kWarps) {",
    ), (
        "  for_rows(xs, row, P, y0, y1, warp, lane, vec, grp,",
        "  for_rows(xs, row, P, y1, y1, warp, lane, vec, grp,",
    )],
}


def _build_variants(parent: Path | None) -> dict[str, ctypes.CDLL]:
    _OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["rot3"].read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        d = _OUT / name
        d.mkdir(exist_ok=True)
        shutil.copy(_build.SOURCES["rot3"].parent / "lerp.cuh", d)
        (d / "rot3.cu").write_text(text)
        jobs[name] = d
    if parent is not None:
        d = _OUT / "parent"
        d.mkdir(exist_ok=True)
        shutil.copy(parent / "rot3.cu", d)
        shutil.copy(parent / "lerp.cuh", d)
        jobs["parent"] = d
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "rot3.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, d in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        regs = [ln.split(":")[-1].strip() for ln in out.splitlines() if "registers" in ln]
        print(f"{name}: {' | '.join(regs)}")
        lib = ctypes.CDLL(str(jobs[name] / "lib.so"))
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        if name == "fwd_timeline":
            lib.livae_rot3_times.argtypes = [p, n]
        if name == "parent":
            lib.livae_rot3_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.livae_rot3_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        else:
            lib.livae_rot3_fwd.argtypes = [p, p, p, p, i, i, i, i, n, i, p]
            lib.livae_rot3_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, n, i, p]
        libs[name] = lib
    return libs


def _ms(fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
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


def _timeline(lib, xp, rp, cp, op, stream) -> None:
    """Per-phase times of the forward's blocks at its planned cluster size."""
    import numpy as np

    plan = R.launch_plan(P, "fwd")
    for _ in range(3):  # the last launch's stamps are read
        err = lib.livae_rot3_fwd(xp, rp, cp, op, B, P, plan.cluster, plan.rows, plan.smem, 1,
                                 stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    nb = B * plan.cluster
    buf = np.zeros(nb * 8, dtype=np.uint64)
    if lib.livae_rot3_times(buf.ctypes.data, buf.nbytes) != 0:
        raise RuntimeError("reading the timestamps failed")
    t = buf.reshape(nb, 8).astype(np.int64)
    us = (t[:, :7] - t[:, 0].min()) / 1000.0
    span = us[:, 6].max()
    print(f"fwd_timeline cluster {plan.cluster}: {nb} blocks over {span:.2f} us")
    names = ["tables", "start barrier", "phase 1", "cluster.sync", "phase 2", "end barrier"]
    for k, name in enumerate(names):
        d = us[:, k + 1] - us[:, k]
        print(f"  {name:13s} mean {d.mean():.3f} us, median {np.median(d):.3f}, "
              f"90th percentile {np.percentile(d, 90):.3f}")
    life = us[:, 6] - us[:, 0]
    print(f"  block life mean {life.mean():.3f} us; mean blocks alive {life.sum() / span:.1f}; "
          f"SMs that ran blocks {len(np.unique(t[:, 7]))}")


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", type=Path, default=None,
                    help="directory with an earlier rot3.cu and lerp.cuh to time alongside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("diag_rot3 needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    libs = _build_variants(args.parent_source)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, P, P), device="cuda", generator=gen).bfloat16()
    g = torch.randn((B, P, P), device="cuda", generator=gen).bfloat16()
    phi = (torch.rand(B, device="cuda", generator=gen) - 0.5) * (torch.pi / 2)
    pos = torch.arange(P, dtype=torch.float32, device="cuda") - (P - 1) / 2.0
    d_row = (-torch.tan(phi / 2)[:, None] * pos).contiguous()
    d_col = (torch.sin(phi)[:, None] * pos).contiguous()
    out, dx = torch.empty_like(x), torch.empty_like(x)
    ddr = torch.empty((B, P), device="cuda")
    ddc = torch.empty((B, P), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [t.data_ptr() for t in (x, d_row, d_col, g, out, dx, ddr, ddc)]
    xp, rp, cp, gp, op, dxp, drp, dcp = ptr

    def run(fn):
        err = fn()
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    results = {}
    for name, lib in libs.items():
        if name == "parent":
            scratch = torch.empty((3, B, P, P), device="cuda")
            sp = scratch.data_ptr()
            results["parent fwd"] = _ms(lambda: run(
                lambda: lib.livae_rot3_fwd(xp, rp, cp, op, sp, B, P, 1, stream)))
            results["parent bwd"] = _ms(lambda: run(
                lambda: lib.livae_rot3_bwd(xp, rp, cp, gp, dxp, drp, dcp, sp, B, P, 1, stream)))
            continue
        for k, sizes in (("fwd", (2, 4, 8)), ("bwd", (4, 8))):
            if k == "bwd" and name.startswith("fwd_"):
                continue
            for n in sizes:
                plan = R.launch_plan(P, k, n)
                if plan.cluster != n:
                    continue
                if k == "fwd":
                    fn = lambda: lib.livae_rot3_fwd(xp, rp, cp, op, B, P, n, plan.rows, plan.smem,
                                                    1, stream)
                else:
                    fn = lambda: lib.livae_rot3_bwd(xp, rp, cp, gp, dxp, drp, dcp, B, P, n,
                                                    plan.rows, plan.smem, 1, stream)
                results[f"{name} {k} cluster {n}"] = _ms(lambda: run(fn))
    if "fwd_timeline" in libs:
        _timeline(libs["fwd_timeline"], xp, rp, cp, op, stream)
    y = torch.empty_like(x)
    results["copy_ bf16 [512, 256, 256] (a yardstick of 128 MiB moved)"] = _ms(lambda: y.copy_(x))
    for key, t in results.items():
        print(f"{key}: {t:.4f} ms")
    return results


if __name__ == "__main__":
    main()
