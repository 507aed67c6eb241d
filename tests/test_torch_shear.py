"""The port's fractional shift (ops/shear.py) against the JAX package, on the CPU.

The plain version (`fractional_shift_reference`, what `fractional_shift` runs
on a CPU tensor) is held against the Pallas kernel in interpret mode and the
XLA shift (`livae_tpu.ops.resample._fractional_shift`); its autograd against
jax.grad through the custom VJP; and `fractional_shift_vjp_reference` against
the VJP's own `_bwd`. The CUDA kernels are held against these plain versions
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.ops.pallas import shear as jshear
from livae_tpu.ops.resample import _fractional_shift
from livae_tpu_torch.ops import shear as S

B, H, W = 4, 24, 40  # not square: the axes cannot be confused


def _case(rng, axis, lo=-60.0, hi=60.0):
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    n_other = H if axis == 2 else W
    delta = rng.uniform(lo, hi, (B, n_other)).astype(np.float32)
    return x, delta


def _xla(x, delta, axis):
    d = delta[:, :, None] if axis == 2 else delta[:, None, :]
    return _fractional_shift(x, d, axis=axis)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_forward_f32_matches_jax(rng, axis, ref):
    """1e-6: the same f32 lerp (XLA's CPU compiler may contract it into an FMA)."""
    x, delta = _case(rng, axis)
    if ref == "xla":
        want = _xla(jnp.asarray(x), jnp.asarray(delta), axis)
    else:
        want = jshear.fractional_shift_pallas(jnp.asarray(x), jnp.asarray(delta), axis, True)
    got = S.fractional_shift(torch.from_numpy(x), torch.from_numpy(delta), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("axis", [1, 2])
def test_bfloat16_io_is_the_f32_result_rounded_once(rng, axis):
    """bf16 in and out, f32 inside: the f32 shift of the bf16 input rounded
    once, and bit-equal to the Pallas kernel's bf16 output."""
    x, delta = _case(rng, axis)
    xb = torch.from_numpy(x).bfloat16()
    d = torch.from_numpy(delta)
    got = S.fractional_shift(xb, d, axis)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, S.fractional_shift(xb.float(), d, axis).bfloat16())
    want = jshear.fractional_shift_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                          jnp.asarray(delta), axis, True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("axis", [1, 2])
def test_integer_shifts_are_rolls(rng, axis):
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    n_other = H if axis == 2 else W
    d = rng.integers(-70, 70, (B, n_other))
    got = S.fractional_shift(torch.from_numpy(x), torch.from_numpy(d.astype(np.float32)),
                             axis).numpy()
    for b in range(B):
        for j in range(n_other):
            if axis == 2:
                np.testing.assert_array_equal(got[b, j], np.roll(x[b, j], -d[b, j]))
            else:
                np.testing.assert_array_equal(got[b, :, j], np.roll(x[b, :, j], -d[b, j]))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("kind", ["random", "integer"])
def test_gradients_match_jax_grad(rng, axis, kind):
    """Autograd through the plain version against jax.grad through the
    custom VJP: x at 1e-5, delta at 1e-4 (tests/test_pallas_shear.py's bounds)."""
    x, delta = _case(rng, axis, -10.0, 10.0)
    if kind == "integer":
        delta = np.round(delta)
    w = rng.standard_normal(x.shape).astype(np.float32)
    gj = jax.grad(lambda a, d: jnp.sum(jnp.asarray(w) * jshear.fractional_shift_pallas(
        a, d, axis, True)), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(delta))
    xt = torch.from_numpy(x).requires_grad_(True)
    dt = torch.from_numpy(delta).requires_grad_(True)
    gt = torch.autograd.grad((torch.from_numpy(w) * S.fractional_shift(xt, dt, axis)).sum(),
                             (xt, dt))
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj[0]), atol=1e-5)
    np.testing.assert_allclose(gt[1].numpy(), np.asarray(gj[1]), atol=1e-4)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_reference_matches_jax_bwd(rng, axis, dtype):
    """fractional_shift_vjp_reference against the custom VJP's `_bwd`: dx is
    the same shift of g (1e-6 in f32, where XLA's CPU compiler may contract
    the lerp into an FMA; bit-equal in bf16), d delta the same products
    summed in another order (1e-4 relative to the largest)."""
    x, delta = _case(rng, axis)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jd = getattr(jnp, dtype)
    xj, gj = jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd)
    dx_j, dd_j = jshear._bwd(axis, True, (xj, jnp.asarray(delta)), gj)
    td = getattr(torch, dtype)
    dx, dd = S.fractional_shift_vjp_reference(
        torch.from_numpy(x).to(td), torch.from_numpy(delta), torch.from_numpy(g).to(td), axis)
    assert dx.dtype == td and dd.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_j, np.float32),
                               atol=1e-6 if dtype == "float32" else 0.0)
    dd_j = np.asarray(dd_j)
    np.testing.assert_allclose(dd.numpy(), dd_j, atol=1e-4 * max(1.0, np.abs(dd_j).max()))


@pytest.mark.parametrize("axis", [1, 2])
def test_vjp_reference_is_autograd_up_to_rounding(rng, axis):
    """The VJP formula and autograd of the plain version compute the same
    gradients: dx within a few f32 ulps (the -delta shift rounds 1 - f once
    more for |delta| < 1), d delta within 1e-4 (another summation order)."""
    x, delta = _case(rng, axis, -3.0, 3.0)
    g = rng.standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    dt = torch.from_numpy(delta).requires_grad_(True)
    ga = torch.autograd.grad(S.fractional_shift_reference(xt, dt, axis), (xt, dt),
                             torch.from_numpy(g))
    gv = S.fractional_shift_vjp_reference(torch.from_numpy(x), torch.from_numpy(delta),
                                          torch.from_numpy(g), axis)
    np.testing.assert_allclose(gv[0].numpy(), ga[0].numpy(),
                               atol=4 * 2.0**-23 * np.abs(g).max())
    np.testing.assert_allclose(gv[1].numpy(), ga[1].numpy(), atol=1e-4)


@pytest.mark.parametrize("bad", ["axis", "delta_shape", "rank"])
def test_shapes_are_checked(bad):
    x = torch.zeros(B, H, W)
    delta = torch.zeros(B, H)
    if bad == "axis":
        args = (x, delta, 0)
    elif bad == "delta_shape":
        args = (x, delta, 1)  # axis 1 wants [B, W]
    else:
        args = (x[0], delta, 2)
    with pytest.raises(ValueError):
        S.fractional_shift(*args)
