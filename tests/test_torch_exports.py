"""The port's import surface against the JAX package's: every package's and
subpackage's public names, and every module `__all__` of the JAX package
that has a counterpart in the port, less the omissions named here with
their reasons. `upsample2x_bilinear` against JAX's through an NHWC <-> NCHW
transpose."""

import importlib
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livae_tpu
import livae_tpu_torch

# name -> why the port has no such name
LEFT_OUT = {
    "TrainState": "a flax PyTreeNode; the port's state is the module and its optimizer",
    "init_params": "a jitted flax init; the port's models initialise in their constructor",
    # GSPMD placement: the port's ranks are processes and its steps take `mesh=`
    "make_mesh": "a jax Mesh of devices; the port's ranks are processes (parallel.spawn)",
    "replicate": "GSPMD placement; DistributedDataParallel broadcasts rank 0's weights",
    "shard_train_step": "a jit with shardings; the port's fused steps take mesh=",
    "shard_eval_step": "a jit with shardings; the port's fused evals take mesh=",
    "fused_epoch_shardings": "jit shardings; the port's fused steps take mesh=",
    # models.layers' flax wrappers: PyTorch's own layers and init are the port's
    "Conv": "a flax wrapper for torch-default init; the port uses nn.Conv2d",
    "ConvTranspose": "a flax wrapper for torch's padding and init; the port uses "
                     "nn.ConvTranspose2d",
    "Dense": "a flax wrapper for torch-default init; the port uses nn.Linear",
    "torch_kernel_init": "flax's PyTorch-default weight init; PyTorch's own layers "
                         "(models.vae.init_torch_default)",
    "torch_bias_init": "flax's PyTorch-default bias init; PyTorch's own layers "
                       "(models.vae.init_torch_default)",
}
# the JAX package's modules with no counterpart: the TPU kernels' Pallas
# bodies (ported as ops/csrc/*.cu behind ops/rot3.py and ops/shear.py) and the
# orbax resume files (utils/resume.py)
NOT_PORTED_MODULES = {"livae_tpu.ops.pallas", "livae_tpu.ops.pallas.rot3",
                      "livae_tpu.ops.pallas.shear", "livae_tpu.utils.orbax_io"}
SUBPACKAGES = ["data", "models", "ops", "train", "utils", "parallel", "sweep"]


def _public(module) -> set[str]:
    """A package's public names: its __all__, else what it binds that is not
    a submodule of its own or an imported module."""
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_top_level_names():
    want = set(livae_tpu.__all__)
    assert len(want) == 40
    assert want <= set(livae_tpu_torch.__all__)
    assert set(livae_tpu_torch.__all__) - want == {"resolve_device"}
    for name in livae_tpu_torch.__all__:
        assert getattr(livae_tpu_torch, name) is not None, name
    assert livae_tpu_torch.__version__ == livae_tpu.__version__ == "0.1.0"
    from livae_tpu_torch import RVAE  # noqa: F401  (the import a user writes first)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names(sub):
    theirs = importlib.import_module(f"livae_tpu.{sub}")
    ours = importlib.import_module(f"livae_tpu_torch.{sub}")
    want = _public(theirs) - set(LEFT_OUT)
    got = _public(ours)
    assert want <= got, sorted(want - got)
    for name in got:
        assert hasattr(ours, name), name
    if sub == "ops":  # the JAX package exports its submodules
        for name in ("fft", "lattice", "peaks", "resample"):
            assert isinstance(getattr(ours, name), types.ModuleType), name


def _jax_modules():
    return sorted(m.name for m in pkgutil.walk_packages(livae_tpu.__path__, "livae_tpu.")
                  if m.name not in NOT_PORTED_MODULES)


@pytest.mark.parametrize("name", _jax_modules())
def test_module_all(name):
    """Each JAX module's __all__, less the named omissions, is in its port's."""
    theirs = importlib.import_module(name)
    ours = importlib.import_module("livae_tpu_torch" + name[len("livae_tpu"):])
    want = set(getattr(theirs, "__all__", [])) - set(LEFT_OUT)
    assert want <= set(getattr(ours, "__all__", want)), sorted(
        want - set(getattr(ours, "__all__", [])))
    for n in want:
        assert hasattr(ours, n), n


def test_every_omission_is_a_jax_name():
    names = set()
    for name in _jax_modules():
        names |= _public(importlib.import_module(name))
    assert set(LEFT_OUT) <= names, sorted(set(LEFT_OUT) - names)


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 5, 7, 1), (3, 1, 2, 2)])
def test_upsample2x_bilinear_matches_jax(rng, shape):
    from livae_tpu.ops.resample import upsample2x_bilinear as jax_up
    from livae_tpu_torch.ops.resample import upsample2x_bilinear

    x = rng.standard_normal(shape).astype(np.float32)  # NHWC
    want = np.asarray(jax_up(jnp.asarray(x)))
    got = upsample2x_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6)


def test_the_decoder_upsamples_through_it(monkeypatch, rng):
    """The decoder's four stages run the fused stage (models.layers), which
    equals upsample2x_bilinear, the reflection pad and the 3x3 convolution."""
    import torch.nn.functional as F

    from livae_tpu_torch.models import layers, rvae

    calls = []
    real = layers.fused_upsample_reflect_conv
    monkeypatch.setattr(layers, "fused_upsample_reflect_conv",
                        lambda x, *a, **k: calls.append(tuple(x.shape)) or real(x, *a, **k))
    model = rvae.RVAE(8, 1, 32, device="cpu")
    with torch.no_grad():
        model.decode(torch.zeros(2, 8))
    assert calls == [(2, 256, 2, 2), (2, 128, 4, 4), (2, 64, 8, 8), (2, 32, 16, 16)]
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 3, 3, 3)).astype(np.float32))
    want = F.conv2d(rvae._reflect_pad1(rvae.upsample2x_bilinear(x)), w)
    torch.testing.assert_close(real(x, w, None), want, atol=2e-5, rtol=1e-5)
