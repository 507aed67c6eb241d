"""The PyTorch port stands alone and never falls back silently.

* Importing livae_tpu_torch, every submodule and chip_smoke.py loads no JAX
  and nothing of livae_tpu, and builds no kernel; it also needs none of the
  optional packages (h5py, tensorboardX, matplotlib, sklearn, pandas), which are
  imported where they are used.
* Every entry point raises when CUDA is wanted by default and absent.
* rot3 and the fractional shift on a CPU tensor take the plain version and
  launch nothing; the kernel paths refuse CPU tensors; a failed build raises.
* The entry points build the kernels before their first step on the card and
  print the seconds; on the CPU they never look for nvcc.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from livae_tpu_torch.ops import _build
from livae_tpu_torch.ops import rot3 as R
from livae_tpu_torch.ops import shear as SH
from livae_tpu_torch.scripts._common import kernel_launches

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys


class _Blocked:
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "livae_tpu", "h5py", "tensorboardX",
               "matplotlib", "sklearn", "pandas")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.BLOCKED:
            raise ImportError(f"{name} is blocked in this probe")


sys.meta_path.insert(0, _Blocked())
import livae_tpu_torch
for m in pkgutil.walk_packages(livae_tpu_torch.__path__, "livae_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
names = sorted(m.name for m in pkgutil.walk_packages(livae_tpu_torch.__path__, "livae_tpu_torch."))
bad = sorted(n for n in sys.modules if n.split(".")[0] in _Blocked.BLOCKED)
from livae_tpu_torch.ops import _build
print("BAD", bad)
print("LIBS", sorted(_build._LIBS))
print("MODULES", " ".join(names))
"""

NEW_MODULES = ["bench", "data.h5", "scripts._common", "scripts.train_rvae", "scripts.train_vae",
               "utils.resume", "models.vae", "train.state", "utils.checkpoint",
               "scripts.visualizations", "scripts.plot_tsne_by_image",
               "scripts.verify_rotational_invariance", "scripts.pretrain_stn",
               "sweep", "sweep.search", "scripts.train_rvae_raytune",
               "scripts.train_rvae_with_best", "scripts.analyze_raytune_results",
               "scripts.compare_training_methods", "scripts.test_raytune_deps",
               "sweep.stacked", "scripts.bench_stacked", "scripts.compare_vae_rvae",
               "scripts.compare_resample_elbo", "scripts.accuracy_program",
               "parallel", "parallel.mesh", "scripts.profile_components",
               "scripts.verify_raytune", "profile_step"]


def test_port_imports_no_jax_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "LIBS []" in out.stdout, out.stdout
    walked = out.stdout.split("MODULES ", 1)[1].split()
    assert {f"livae_tpu_torch.{m}" for m in NEW_MODULES} <= set(walked)


def test_optional_packages_are_imported_where_they_are_used():
    """h5py, tensorboardX, matplotlib, sklearn and pandas appear only inside
    functions."""
    import ast

    for path in sorted((REPO / "livae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:  # module-level statements only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0] in ("h5py", "tensorboardX", "matplotlib",
                                                   "sklearn", "pandas")
                               for n in names), f"{path.name} imports {names} at module level"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from livae_tpu_torch import bench_rotate
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
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_rotate.main(["--batch", "2", "--reps", "1"])

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


def test_rot3_on_cpu_takes_the_plain_version(rng):
    before = kernel_launches()
    x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(-3, 3, (2, 16)).astype(np.float32)).requires_grad_(True)
    out = R.rot3(x, d, d)
    out.sum().backward()
    assert torch.equal(out, R.rot3_reference(x, d, d))
    assert kernel_launches() == before
    assert not _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        R.Rot3Function.apply(x, d, d)


def test_shear_on_cpu_takes_the_plain_version(rng):
    before = kernel_launches()
    x = torch.from_numpy(rng.standard_normal((2, 16, 12)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(-3, 3, (2, 12)).astype(np.float32)).requires_grad_(True)
    out = SH.fractional_shift(x, d, 1)
    out.sum().backward()
    assert torch.equal(out, SH.fractional_shift_reference(x, d, 1))
    assert kernel_launches() == before
    assert not _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        SH.FractionalShiftFunction.apply(x, d, 1)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build_all()
    assert not list(tmp_path.iterdir())


def test_prebuild_kernels_builds_on_the_card_only(monkeypatch, capsys):
    """On the CPU: nothing built, nvcc not looked for, nothing printed. On a CUDA
    device: build_all once per call, and its seconds printed (to the file asked
    for)."""
    import io

    from livae_tpu_torch.scripts._common import prebuild_kernels

    def no_nvcc():
        raise AssertionError("looked for nvcc")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert prebuild_kernels(torch.device("cpu")) == 0.0
    assert capsys.readouterr().out == ""
    calls = []
    monkeypatch.setattr(_build, "build_all", lambda: calls.append(1) or 1.25)
    assert prebuild_kernels(torch.device("cuda")) == 1.25
    assert capsys.readouterr().out == "kernel build: 1.25 s\n"
    err = io.StringIO()
    prebuild_kernels(torch.device("cuda", 0), file=err)
    assert err.getvalue() == "kernel build: 1.25 s\n" and calls == [1, 1]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["scripts.train_rvae", "scripts.train_vae",
                                   "scripts.pretrain_stn", "bench"])
def test_entry_points_build_before_their_dataset(monkeypatch, entry):
    """Each training entry point calls prebuild_kernels on its device before
    it builds its dataset (where the test stops it)."""
    import importlib

    module = importlib.import_module(f"livae_tpu_torch.{entry}")
    order = []

    def dataset(*a, **k):
        order.append("dataset")
        raise _Stop

    monkeypatch.setattr(module, "prebuild_kernels",
                        lambda device, file=None: order.append(("build", device.type)) or 0.0)
    monkeypatch.setattr(module, "PairedAdaptiveLatticeDataset" if hasattr(
        module, "PairedAdaptiveLatticeDataset") else "AdaptiveLatticeDataset", dataset)
    if entry == "bench":
        run = lambda: module.run(module.build_argparser().parse_args(  # noqa: E731
            ["--cpu", "--frame-size", "64"]))
    else:
        monkeypatch.setattr(module, "resolve_images", lambda args: [np.zeros((8, 8))])
        runner = getattr(module, "run_training", None) or module.run_pretrain
        run = lambda: runner(module.build_argparser().parse_args(["--cpu"]))  # noqa: E731
    with pytest.raises(_Stop):
        run()
    assert order == [("build", "cpu"), "dataset"]


def test_analysis_scripts_build_before_their_dataset(monkeypatch, tmp_path):
    """The analysis scripts share load_for_analysis: the kernels, then the
    checkpoint's model, then the dataset."""
    from livae_tpu_torch.models.rvae import RVAE
    from livae_tpu_torch.scripts import visualizations
    from livae_tpu_torch.utils.checkpoint import save_reference_checkpoint

    path = tmp_path / "rvae.pt"
    save_reference_checkpoint(path, RVAE(8, 1, 32, device="cpu").state_dict(),
                              args={"latent_dim": 8, "patch_size": 32})
    order = []

    def dataset(*a, **k):
        order.append("dataset")
        raise _Stop

    monkeypatch.setattr(visualizations, "prebuild_kernels",
                        lambda device: order.append(("build", device.type)))
    monkeypatch.setattr(visualizations, "AdaptiveLatticeDataset", dataset)
    args = visualizations.build_argparser().parse_args(["--cpu", "--checkpoint", str(path)])
    with pytest.raises(_Stop):
        visualizations.load_for_analysis(args, None, images=[np.zeros((8, 8))])
    assert order == [("build", "cpu"), "dataset"]


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_sweep_builds_before_its_first_trial(monkeypatch, tmp_path, executor):
    """train_rvae_raytune builds the kernels in the parent, before any trial
    (a thread or a spawned child) starts: the trials only load them."""
    from livae_tpu_torch.scripts import train_rvae_raytune as sweep

    order = []
    monkeypatch.setattr(sweep, "prebuild_kernels",
                        lambda device: order.append(("build", device.type)) or 0.0)
    monkeypatch.setattr(sweep, "resolve_images", lambda args: [np.zeros((8, 8))])
    monkeypatch.setattr(sweep, "run_search", lambda *a, **k: order.append("trials") or [])
    sweep.run_hyperparameter_search(sweep.build_argparser().parse_args(
        ["--cpu", "--executor", executor, "--ray-results-dir", str(tmp_path)]))
    assert order == [("build", "cpu"), "trials"]
