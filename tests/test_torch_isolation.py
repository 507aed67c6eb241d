"""The PyTorch port stands alone and never falls back silently.

* Importing livae_tpu_torch, every submodule and chip_smoke.py loads no JAX
  and nothing of livae_tpu, and builds no kernel.
* Every entry point raises when CUDA is wanted by default and absent.
* rot3 on a CPU tensor takes the plain version and launches nothing; the
  kernel path refuses CPU tensors; a failed build raises.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import rot3 as R

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import livae_tpu_torch
for m in pkgutil.walk_packages(livae_tpu_torch.__path__, "livae_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "livae_tpu"))
from livae_tpu_torch.ops import _build
print("BAD", bad)
print("LIBS", sorted(_build._LIBS))
"""


def test_port_imports_no_jax_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "LIBS []" in out.stdout, out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from livae_tpu_torch.data.datasets import PairedAdaptiveLatticeDataset
    from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
    from livae_tpu_torch.models.rvae import RVAE
    from livae_tpu_torch.ops.lattice import estimate_lattice_constant
    from livae_tpu_torch.train import engine

    frame, _ = synthetic_mos2_frame(size=256, spacing=20.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        RVAE(8, 1, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PairedAdaptiveLatticeDataset([frame], patch_size=32, padding=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_lattice_constant(frame)

    model = RVAE(8, 1, 32, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    kw = dict(patch_size=32, padding=8, margin=40)
    factories = [
        lambda: engine.make_rvae_train_step(model, opt),
        lambda: engine.make_fused_rvae_train_step(model, opt, cfg=None, **kw),
        lambda: engine.make_fused_rvae_eval(model, cfg=None, **kw),
        lambda: engine.make_fused_encode(model, **kw),
    ]
    for make in factories:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_rot3_on_cpu_takes_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(R, "FWD_LAUNCHES", 0)
    monkeypatch.setattr(R, "BWD_LAUNCHES", 0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(-3, 3, (2, 16)).astype(np.float32)).requires_grad_(True)
    out = R.rot3(x, d, d)
    out.sum().backward()
    assert torch.equal(out, R.rot3_reference(x, d, d))
    assert R.FWD_LAUNCHES == 0 and R.BWD_LAUNCHES == 0
    assert not _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        R.Rot3Function.apply(x, d, d)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build_all()
    assert not list(tmp_path.iterdir())
