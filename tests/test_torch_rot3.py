"""rot3 of the PyTorch port against the JAX package, on the CPU.

The port's plain version (`rot3_reference`, what `rot3` runs on a CPU tensor)
is held against the Pallas kernel in interpret mode and the XLA 3-shear path:
values at f32, bf16 I/O, and gradients against jax.grad. The CUDA kernels
are held against this plain version on the card by chip_smoke.py; their
launch plan (cluster size, bands of rows, shared memory) is plain Python and
is checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.ops.pallas.rot3 import rot3_pallas
from livae_tpu.ops.resample import _fractional_shift
from livae_tpu_torch.ops.rot3 import MAX_P, launch_plan, rot3, rot3_reference


def _xla_rot3(x, d_row, d_col):
    out = _fractional_shift(x, d_row[:, :, None], axis=2)
    out = _fractional_shift(out, d_col[:, None, :], axis=1)
    return _fractional_shift(out, d_row[:, :, None], axis=2)


@pytest.fixture
def case(rng):
    B, P = 4, 64
    x = rng.standard_normal((B, P, P)).astype(np.float32)
    d_row = rng.uniform(-20, 20, (B, P)).astype(np.float32)
    d_col = rng.uniform(-20, 20, (B, P)).astype(np.float32)
    return x, d_row, d_col


def _deltas(kind, rng, B, P, d_row, d_col):
    d_int = rng.integers(-5, 6, (B, P)).astype(np.float32)
    half = (np.arange(P) % 2).astype(np.float32)  # alternate integer / fractional
    return {
        "random": (d_row, d_col),
        "integer": (d_int, d_int),
        "zero_row": (np.zeros((B, P), np.float32), d_int),
        "mixed": (d_int + half * 0.37, d_int),
    }[kind]


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_forward_f32_matches_jax(case, ref):
    x, d_row, d_col = case
    if ref == "xla":
        want = _xla_rot3(jnp.asarray(x), jnp.asarray(d_row), jnp.asarray(d_col))
    else:
        want = rot3_pallas(jnp.asarray(x), jnp.asarray(d_row), jnp.asarray(d_col), True)
    got = rot3_reference(torch.from_numpy(x), torch.from_numpy(d_row), torch.from_numpy(d_col))
    # same f32 operations in the same order; 1e-6 is the JAX package's own bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_bfloat16_io_bit_equal(case):
    """f32 through all three stages and one cast: bit-equal to both JAX paths."""
    x, d_row, d_col = case
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_xla = _xla_rot3(xb, jnp.asarray(d_row), jnp.asarray(d_col)).astype(jnp.bfloat16)
    want_pl = rot3_pallas(xb, jnp.asarray(d_row), jnp.asarray(d_col), True)
    got = rot3(torch.from_numpy(x).bfloat16(), torch.from_numpy(d_row), torch.from_numpy(d_col))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want_xla, dtype=np.float32))
    np.testing.assert_array_equal(got, np.asarray(want_pl, dtype=np.float32))


@pytest.mark.parametrize("kind", ["random", "integer", "zero_row", "mixed"])
def test_gradients_match_jax_grad(case, rng, kind):
    """dx, d d_row, d d_col against jax.grad of the XLA path, including
    exact-integer shifts (f == 0). Tolerances are those of
    tests/test_pallas_rot3.py: x 1e-5, deltas 1e-3 (sums of P products taken
    in another order)."""
    x, d_row, d_col = case
    B, P = x.shape[:2]
    d_row, d_col = _deltas(kind, rng, B, P, d_row, d_col)
    w = rng.standard_normal(x.shape).astype(np.float32)

    gj = jax.grad(lambda a, b, c: jnp.sum(jnp.asarray(w) * _xla_rot3(a, b, c)),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(d_row), jnp.asarray(d_col))
    xt, dr, dc = (torch.from_numpy(v).requires_grad_(True) for v in (x, d_row, d_col))
    gt = torch.autograd.grad((torch.from_numpy(w) * rot3(xt, dr, dc)).sum(), (xt, dr, dc))
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj[0]), atol=1e-5)
    np.testing.assert_allclose(gt[1].numpy(), np.asarray(gj[1]), atol=1e-3)
    np.testing.assert_allclose(gt[2].numpy(), np.asarray(gj[2]), atol=1e-3)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("P", [2, 3, 33, 130, 256, 384, MAX_P])
def test_launch_plan_covers_the_canvas(P, direction):
    """The cluster's bands cover rows 0..P-1 once each, none empty; the cluster
    is a portable size; a block's shared memory fits sm_90's 232,448 bytes."""
    plan = launch_plan(P, direction)
    assert plan.cluster in (1, 2, 4, 8)
    assert [r for band in plan.bands for r in band] == list(range(P))
    assert all(len(band) > 0 for band in plan.bands)
    assert 0 < plan.smem <= 232_448
    with pytest.raises(ValueError, match="canvas"):
        launch_plan(MAX_P + 1, direction)


def test_launch_plan_main_path_clusters():
    """The main path's canvas (256): clusters of 4 for the forward and 8 for
    the backward, as measured; an explicit size is kept where it fits."""
    assert launch_plan(256, "fwd").cluster == 4
    assert launch_plan(256, "bwd").cluster == 8
    assert launch_plan(256, "fwd", 8).cluster == 8
    assert launch_plan(256, "bwd", 1).cluster == 4  # the smallest cluster that holds the bands
    with pytest.raises(ValueError, match="cluster"):
        launch_plan(256, "fwd", 3)
