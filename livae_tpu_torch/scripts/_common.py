"""Shared plumbing of the training entry points (port of scripts/_common.py).

Data resolution: `--data` .h5 paths, else data/*.h5, else `--synthetic N`
ground-truthed synthetic MoS2 frames. Device flags: the entry points run on
the CUDA device unless `--cpu` is passed; the trainers' `--num-devices N`
runs them on N spawned ranks, N / M data ways x M model ways with
`--model-parallel M` (`run_data_parallel`). Randomness: every epoch's generator
is seeded from (seed, stream, epoch), so a resumed run draws what an
uninterrupted one draws. Kernels: every entry point builds them with
`prebuild_kernels` before its first timed step.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..data.h5 import load_image_from_h5
from ..data.synthetic import synthetic_mos2_frame
from ..device import resolve_device
from ..parallel.mesh import (
    DataMesh,
    dense_param_specs,
    place_with_specs,
    setup_mesh_from_flags,
    spawn,
)
from ..parallel.tensor import full_optimizer_state, full_state_dict, unplace


def resolve_images(args) -> list[np.ndarray]:
    """Load frames from --data h5 paths, data/*.h5, or --synthetic."""
    if getattr(args, "synthetic", 0):
        size = getattr(args, "synthetic_size", 1024)
        kwargs = {}
        if getattr(args, "synthetic_vacancy_rate", None) is not None:
            kwargs["vacancy_rate"] = args.synthetic_vacancy_rate
        if getattr(args, "synthetic_s_amplitude", None) is not None:
            kwargs["s_amplitude"] = args.synthetic_s_amplitude
        print(f"Generating {args.synthetic} synthetic MoS2 frames ({size}x{size})...")
        return [
            synthetic_mos2_frame(size=size, spacing=40.0, seed=s, **kwargs)[0]
            for s in range(args.synthetic)
        ]
    paths = args.data if args.data else sorted(glob.glob("data/*.h5"))
    if not paths:
        raise SystemExit("No input data: pass --data <files.h5> or --synthetic N")
    print(f"Loading {len(paths)} HDF5 frames...")
    return [load_image_from_h5(p, getattr(args, "dataset_name", None)) for p in paths]


def add_data_flags(parser) -> None:
    parser.add_argument("--data", nargs="*", help="Paths to H5 files (default: data/*.h5)")
    parser.add_argument(
        "--dataset-name",
        type=str,
        default=None,
        help="Dataset path inside H5 file; auto-detects a 2D dataset if omitted",
    )
    parser.add_argument(
        "--synthetic",
        type=int,
        default=0,
        help="Generate N synthetic MoS2 frames instead of loading .h5 data",
    )
    parser.add_argument(
        "--synthetic-size", type=int, default=1024, help="Synthetic frame size"
    )
    parser.add_argument(
        "--synthetic-vacancy-rate", type=float, default=None,
        help="S-vacancy rate for synthetic frames (default: the generator's 0.03)",
    )
    parser.add_argument(
        "--synthetic-s-amplitude", type=float, default=None,
        help="S-site amplitude for synthetic frames (vacancy regime: 0.45)",
    )


def add_device_flags(parser, mp_help: str) -> None:
    parser.add_argument(
        "--num-devices",
        type=str,
        default="1",
        help='Total devices: an integer or "auto" (all local devices)',
    )
    parser.add_argument("--model-parallel", type=int, default=1, help=mp_help)


def resolve_run_device(args) -> torch.device:
    """The run's device: CUDA, or the CPU with --cpu (the only way onto it)."""
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)


def _rank_run(mesh, device, train, args) -> dict:
    out = train(mesh, device, args)
    unplace(out["model"])  # every rank gathers; rank 0's one-device model pickles
    return {k: v for k, v in out.items() if k not in ("optimizer", "scheduler")}


def run_data_parallel(train, args, device: torch.device, model_fn=None) -> dict | None:
    """With --num-devices N > 1: build the kernels once, run train(mesh,
    device, args) on N spawned ranks, N / M data ways x M model ways with
    --model-parallel M (rendezvous in the checkpoint's directory), and return
    rank 0's result, its model gathered into the one-device model, less its
    optimizer and schedule (they do not pickle). None for one device: the
    caller trains in this process. Exits on flags the mesh cannot take
    (`setup_mesh_from_flags`); `model_fn()` builds a host copy of the run's
    model for the count of split parameters it prints."""
    mp = int(getattr(args, "model_parallel", 1))
    n_data, n_model = setup_mesh_from_flags(
        getattr(args, "num_devices", "1"), mp, args.batch_size, device.type,
        model_fn() if mp > 1 and model_fn is not None else None)
    if n_data * n_model == 1:
        return None
    build_s = prebuild_kernels(device)
    result = spawn(_rank_run, n_data * n_model, train, args, device_type=device.type,
                   root=Path(args.checkpoint).parent, model_parallel=n_model)
    result["kernel_build_s"] = build_s
    return result


def place_model(model: torch.nn.Module, mesh: DataMesh | None) -> torch.nn.Module:
    """Under a mesh with model ways, split the model's large dense layers
    over them (`dense_param_specs`, `place_with_specs`); the optimizer must
    be built after. Returns the model."""
    if mesh is not None and mesh.model_size > 1:
        place_with_specs(model, mesh, dense_param_specs(model, mesh.model_size))
    return model


def note_ignored_flags(args) -> None:
    for flag, default in (("num_workers", 8), ("prefetch_factor", 4), ("compile", False)):
        if getattr(args, flag, default) != default:
            print(f"note: --{flag.replace('_', '-')} is accepted and ignored: batches are "
                  "extracted on the device")


def prebuild_kernels(device: torch.device, file=None) -> float:
    """Build every CUDA kernel now, before the first timed step, and print
    `kernel build: <s> s` (to `file`, default stdout). On the CPU nothing is
    built and nvcc is not looked for. Returns the seconds spent."""
    if device.type != "cuda":
        return 0.0
    from ..ops import _build

    seconds = _build.build_all()
    print(f"kernel build: {seconds:.2f} s", file=file or sys.stdout, flush=True)
    return seconds


def batched(indices: np.ndarray, batch_size: int, drop_last: bool = True):
    """Consecutive chunks of `indices`; the ragged tail too unless drop_last."""
    n = len(indices)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, max(stop, 0), batch_size):
        yield indices[i : i + batch_size]
    if not drop_last and stop < n:
        yield indices[stop:]


def split_indices(n: int, val_split: float, seed: int = 0):
    """Deterministic train/val index split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_split))
    return perm[n_val:], perm[:n_val]


def stream_generator(seed: int, stream: str, epoch: int, device) -> torch.Generator:
    """A fresh generator on `device` for one (seed, stream, epoch). Streams
    ("init", "train", "val", "vis") are independent, and no generator lives
    across epochs, so resuming needs no replay of history."""
    digest = hashlib.sha256(f"{seed}/{stream}/{epoch}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def epoch_index_batches(train_idx: torch.Tensor, batch_size: int,
                        generator: torch.Generator) -> torch.Tensor:
    """[steps, batch_size] shuffled train indices for one epoch (drop last)."""
    steps = len(train_idx) // batch_size
    perm = torch.randperm(len(train_idx), generator=generator, device=train_idx.device)
    return train_idx[perm[: steps * batch_size]].reshape(steps, batch_size)


def state_digest(model, optimizer, scheduler=None, mesh: DataMesh | None = None) -> str:
    """Order-stable sha256 over every weight, optimizer-state tensor and the
    schedule's count (LIVAE_PARAM_HASH=1 prints it each epoch): a resumed run
    must print the digests of an uninterrupted one. Under a model axis the
    state is the one-device state, gathered (every rank calls this)."""
    h = hashlib.sha256()

    def feed(obj):
        if isinstance(obj, torch.Tensor):
            h.update(obj.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(obj, dict):
            for k in obj:
                feed(obj[k])
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                feed(v)

    feed(full_state_dict(model, mesh))
    feed(full_optimizer_state(optimizer, mesh)["state"])
    h.update(str(scheduler.last_epoch if scheduler is not None else 0).encode())
    return h.hexdigest()[:16]


KERNELS = ("rot3_fwd", "rot3_bwd", "shear_fwd", "shear_bwd", "upconv_fwd", "upconv_bwd",
           "phasemax_fwd", "phasemax_bwd")


def kernel_launches() -> dict[str, int]:
    """The CUDA kernels' launch counters (0 on the CPU, which launches none)."""
    counts = tracing.counters()
    return {k: counts.get(k, 0) for k in KERNELS}


def card_description(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_epoch(enabled: bool, log_dir: str, device: torch.device):
    """Trace the enclosed epoch with torch.profiler into <log-dir>/profile;
    the program's spans (`livae_tpu_torch.tracing`) go into its trace as
    record_function ranges of their names."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out = Path(log_dir) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof, tracing.recording(ranges=True):
        yield
        sync(device)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"Profiler trace written to {out}")
