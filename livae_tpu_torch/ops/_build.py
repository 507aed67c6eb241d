"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `ops/csrc/` compiles into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

The libraries go into `livae_tpu_torch/_build/` (listed in `.gitignore`), or
into the directory `LIVAE_TORCH_BUILD_DIR` names (for an install the process
cannot write into), named by a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source rebuilds and an unchanged one is reused. Nothing
is built when a module is imported: the first launch builds, or a caller
builds every kernel up front with `build_all()` (one nvcc process per
source, all started together). A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "BUILD_LOG", "build_all", "is_built", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get("LIVAE_TORCH_BUILD_DIR")
                 or Path(__file__).resolve().parent.parent / "_build")
SOURCES = {"rot3": _CSRC / "rot3.cu", "shear": _CSRC / "shear.cu", "upconv": _CSRC / "upconv.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> nvcc's output (ptxas register / shared-memory report) of the last build
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # one build and one load per kernel, whatever the threads


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _target(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def is_built(name: str) -> bool:
    """Whether kernel `name`'s library for the current sources is on disk."""
    return _target(name).exists()


def build_all(names=None) -> float:
    """Compile the named kernels (default: all) that are not built yet.

    Starts one nvcc per source, all at once, and waits for them. Returns the
    wall-clock seconds spent. Raises RuntimeError on any failed build.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not is_built(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
    return lib
