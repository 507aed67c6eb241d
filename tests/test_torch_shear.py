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


# --- kernel C's launch plan (plain Python) and the dx-free flag -------------------

from livae_tpu_torch.ops import resample as RS  # noqa: E402

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# chip_smoke.py's edge shapes for kernel C, and the per-shear rotation's canvas
PLAN_SHAPES = [(3, p, p) for p in (2, 33, 130, 255, 432, 640, 1024)] + [(3, 33, 130),
                                                                       (512, 256, 256)]


def _covered(plan):
    """Every (row) or (sample, column) a plan's tiles cover, in order."""
    if plan.axis == 2:
        return [r for t in plan.tiles() for r in t]
    return [(b, c) for b, cols in plan.tiles() for c in cols]


def _every(plan):
    B, H, W = plan.B, plan.H, plan.W
    if plan.axis == 2:
        return list(range(B * H))
    return [(b, c) for b in range(B) for c in range(W)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_tiles_cover_every_row_or_column_once(shape, axis, dtype):
    """Both kernels get a tiled plan whose tiles cover each row (axis 2) or
    each column of each sample (axis 1) exactly once, within one block's
    shared memory, with the bytes of the kernels' layout."""
    for direction in ("fwd", "bwd"):
        plan = S.launch_plan(*shape, axis, direction, _DT[dtype])
        assert plan.variant == "tiled"
        assert plan.smem <= S.SMEM_PER_BLOCK == 232_448
        assert plan.smem == S._smem(axis, direction, shape[1], shape[2], plan.tile,
                                    2 if dtype == "bfloat16" else 4)
        if axis == 1:
            assert plan.tile in S.STRIP_COLUMNS
        assert _covered(plan) == _every(plan)


@pytest.mark.parametrize("shape,axis,direction,dtype", [
    ((3, 4000, 4000), 1, "bwd", "float32"),  # x and g strips of 8 columns: 256,000 B
    ((1, 40000, 2), 1, "fwd", "bfloat16"),  # one strip of 8 columns: 640,000 B
    ((2, 3, 60000), 2, "fwd", "float32"),  # one row: 240,000 B
    ((2, 3, 60000), 2, "bwd", "bfloat16"),  # a row of x and of g: 240,032 B
])
def test_launch_plan_takes_the_direct_variant_beyond_shared_memory(shape, axis, direction,
                                                                   dtype):
    """A tile that fits no block takes the direct kernel (no tile, no shared
    memory), never the plain version; a hand-picked tile that does not fit
    raises."""
    plan = S.launch_plan(*shape, axis, direction, _DT[dtype])
    assert (plan.variant, plan.tile, plan.smem) == ("direct", 0, 0)
    assert _covered(plan) == _every(plan)
    with pytest.raises(ValueError):
        S.launch_plan(*shape, axis, direction, _DT[dtype], tile=8 if axis == 1 else 1)


def _record_launches(monkeypatch):
    """Route the kernel wrappers to the plain versions; record with_dx."""
    seen = []
    monkeypatch.setattr(S, "_launch_fwd", lambda x, d, a: S.fractional_shift_reference(x, d, a))

    def bwd(x, d, g, a, with_dx=True):
        seen.append(with_dx)
        dx, dd = S.fractional_shift_vjp_reference(x, d, g, a)
        return (dx if with_dx else None), dd

    monkeypatch.setattr(S, "_launch_bwd", bwd)
    return seen


@pytest.mark.parametrize("x_needs_grad", [True, False])
@pytest.mark.parametrize("axis", [1, 2])
def test_backward_launches_dx_free_exactly_when_x_needs_no_grad(monkeypatch, rng, axis,
                                                                x_needs_grad):
    seen = _record_launches(monkeypatch)
    x, delta = _case(rng, axis)
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_(x_needs_grad)
    dt = torch.from_numpy(delta).requires_grad_(True)
    (S.FractionalShiftFunction.apply(xt, dt, axis) * w).sum().backward()
    assert seen == [x_needs_grad]
    assert (xt.grad is not None) == x_needs_grad
    want = S.fractional_shift_vjp_reference(xt.detach(), dt.detach(), w, axis)[1]
    assert torch.equal(dt.grad, want)


@pytest.mark.parametrize("image_needs_grad", [False, True])
def test_per_shear_rotation_launches_dx_free_for_its_first_shift(monkeypatch, rng,
                                                                 image_needs_grad):
    """rotate_image_fast(backend="shear") on data: the backward runs the shifts
    in reverse, and only the first shift (on the data) drops dx."""
    seen = _record_launches(monkeypatch)
    monkeypatch.setattr(RS, "fractional_shift", S.FractionalShiftFunction.apply)
    img = torch.from_numpy(rng.random((2, 1, 16, 16), np.float32)).requires_grad_(
        image_needs_grad)
    th = torch.tensor([0.3, -1.1], requires_grad=True)
    out = RS.rotate_image_fast(img, th, "reflection", backend="shear")
    out.square().sum().backward()
    assert seen == [True, True, image_needs_grad]
    assert th.grad is not None and bool(torch.isfinite(th.grad).all())
