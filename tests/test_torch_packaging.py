"""The port installs whole: a wheel of the project carries the CUDA sources
its first launch compiles (MANIFEST.in), and `LIVAE_TORCH_BUILD_DIR` moves the
compiled libraries out of the package (a read-only install), with a failed
build still raising there."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCES = {"livae_tpu_torch/ops/csrc/rot3.cu", "livae_tpu_torch/ops/csrc/shear.cu",
           "livae_tpu_torch/ops/csrc/lerp.cuh"}


def test_wheel_carries_the_cuda_sources(tmp_path):
    """Built offline (no index, no build isolation, no dependencies) from a
    copy of the packaging files and the port, never in the repository."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "MANIFEST.in", "README.md"):
        shutil.copy(REPO / name, src / name)
    shutil.copytree(REPO / "livae_tpu_torch", src / "livae_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build", "*.pyc"))
    env = {**os.environ, "TMPDIR": str(tmp_path), "PIP_NO_CACHE_DIR": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "-w", str(tmp_path / "dist"), str(src)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert SOURCES <= names, sorted(n for n in names if "csrc" in n)
    assert "livae_tpu_torch/ops/_build.py" in names
    assert "livae_tpu_torch/parallel/mesh.py" in names


_PROBE = r"""
from pathlib import Path
from livae_tpu_torch.ops import _build
print("DIR", _build.BUILD_DIR)
print("TARGET", _build._target("rot3").parent)
_build._nvcc = lambda: "false"
try:
    _build.build_all()
except RuntimeError as e:
    print("RAISED", "kernel build failed" in str(e))
print("LEFT", sorted(p.name for p in Path(_build.BUILD_DIR).iterdir()))
"""


def test_build_dir_follows_the_environment(tmp_path):
    where = tmp_path / "kernels"
    env = {k: v for k, v in os.environ.items() if k != "LIVAE_TORCH_BUILD_DIR"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**env, "LIVAE_TORCH_BUILD_DIR": str(where)})
    assert out.returncode == 0, out.stderr
    assert f"DIR {where}\n" in out.stdout and f"TARGET {where}\n" in out.stdout
    assert "RAISED True" in out.stdout and "LEFT []" in out.stdout
    default = subprocess.run([sys.executable, "-c", "from livae_tpu_torch.ops import _build; "
                              "print(_build.BUILD_DIR)"], cwd=REPO, capture_output=True,
                             text=True, timeout=120, env=env)
    assert default.stdout.strip() == str(REPO / "livae_tpu_torch" / "_build")
