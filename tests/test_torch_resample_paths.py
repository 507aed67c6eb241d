"""The port's rotation paths against livae_tpu.ops.resample on the CPU.

* `rotate_image_fast` rotates what the JAX package rotates: several channels
  and canvases above the fused rot3's limit take the per-shear path, the
  counterpart of JAX's `backend="xla"` branch.
* The per-shear path and the fused rot3 give the same bits.
* The exact resampler (`affine_grid`, `grid_sample`, `sample_at_pixels`,
  `rotate_image`) against the JAX package's XLA gather version.

Images are NCHW in the port and NHWC in JAX; the tests transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.ops import resample as jr
from livae_tpu_torch.ops import resample as tr

THETAS = np.array([0.3, -1.2, 2.0, 3.5, -2.9, 0.0, np.pi / 4, -0.05], np.float32)
MODES = ["zeros", "border", "reflection"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize(
    "shape,padding_mode",
    [((2, 3, 32, 32), "zeros"), ((2, 3, 32, 32), "reflection"), ((1, 1, 640, 640), "reflection")],
    ids=["C3-zeros", "C3-reflection", "S640-canvas1024"],
)
def test_rotate_image_fast_rotates_what_jax_rotates(rng, shape, padding_mode):
    """C = 3 and a 1024 canvas (S = 640) take the per-shear path. 1e-6: both
    sides run the same f32 lerps in the same order."""
    B, C, S, _ = shape
    img = rng.random((B, S, S, C)).astype(np.float32)
    th = THETAS[:B]
    want = jax.jit(lambda a, b: jr.rotate_image_fast(a, b, padding_mode, backend="xla"))(
        jnp.asarray(img), jnp.asarray(th))
    got = tr.rotate_image_fast(_nchw(img), torch.from_numpy(th), padding_mode)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)


def test_rotate_image_fast_three_channels_gradients(rng):
    """Gradients through the per-shear path at the bounds of
    tests/test_torch_resample.py: the image 1e-5, theta rtol 1e-4 / atol 1e-3."""
    img = rng.random((4, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal(img.shape).astype(np.float32)
    th = THETAS[:4]

    def jfun(a, b):
        return jnp.sum(jnp.asarray(w) * jr.rotate_image_fast(a, b, "reflection", backend="xla"))

    gj = jax.jit(jax.grad(jfun, argnums=(0, 1)))(jnp.asarray(img), jnp.asarray(th))
    it = _nchw(img).requires_grad_(True)
    tt = torch.from_numpy(th).requires_grad_(True)
    out = tr.rotate_image_fast(it, tt, "reflection")
    gi, gth = torch.autograd.grad((_nchw(w) * out).sum(), (it, tt))
    np.testing.assert_allclose(_nhwc(gi), np.asarray(gj[0]), atol=1e-5)
    np.testing.assert_allclose(gth.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_backend_bit_equal_to_fused(rng, dtype):
    """Both backends run three f32 lerp shifts and cast once: same bits, and
    the same gradients up to the order of the delta sums."""
    img = torch.from_numpy(rng.random((len(THETAS), 1, 32, 32)).astype(np.float32)).to(dtype)
    th = torch.from_numpy(THETAS)
    outs, grads = {}, {}
    for backend in ("fused", "shear"):
        t = th.clone().requires_grad_(True)
        outs[backend] = tr.rotate_image_fast(img, t, "reflection", backend=backend)
        grads[backend] = torch.autograd.grad(outs[backend].float().square().sum(), t)[0]
    assert outs["shear"].dtype == dtype
    assert torch.equal(outs["shear"], outs["fused"])
    np.testing.assert_allclose(grads["shear"].numpy(), grads["fused"].numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 1, 640, 640)], ids=["C3", "canvas1024"])
def test_fused_backend_refuses_what_rot3_cannot_take(shape):
    with pytest.raises(ValueError, match="fused"):
        tr.rotate_image_fast(torch.zeros(shape), torch.zeros(shape[0]), backend="fused")
    with pytest.raises(ValueError, match="backend"):
        tr.rotate_image_fast(torch.zeros(shape), torch.zeros(shape[0]), backend="xla")


@pytest.mark.parametrize("padding_mode", MODES)
def test_grid_sample_matches_jax(rng, padding_mode):
    """Random grids reaching past the border: 1e-5 (ATen and the JAX gather
    sum the four corners in another order)."""
    img = rng.random((3, 12, 10, 2)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (3, 7, 9, 2)).astype(np.float32)
    want = jr.grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode)
    got = tr.grid_sample(_nchw(img), torch.from_numpy(grid), padding_mode)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("padding_mode", MODES)
def test_rotate_image_matches_jax(rng, padding_mode):
    img = rng.random((len(THETAS), 24, 24, 2)).astype(np.float32)
    want = jr.rotate_image(jnp.asarray(img), jnp.asarray(THETAS), padding_mode)
    got = tr.rotate_image(_nchw(img), torch.from_numpy(THETAS), padding_mode)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("padding_mode", MODES)
def test_sample_at_pixels_matches_jax(rng, padding_mode):
    """Pixel coordinates [B, N] past the border: the same gather and lerp as
    the JAX function, 1e-6."""
    img = rng.random((2, 9, 11, 3)).astype(np.float32)
    ix = rng.uniform(-4, 15, (2, 40)).astype(np.float32)
    iy = rng.uniform(-4, 13, (2, 40)).astype(np.float32)
    want = jr.sample_at_pixels(jnp.asarray(img), jnp.asarray(ix), jnp.asarray(iy), padding_mode)
    got = tr.sample_at_pixels(_nchw(img), torch.from_numpy(ix), torch.from_numpy(iy),
                              padding_mode)
    assert tuple(got.shape) == (2, 3, 40)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want), atol=1e-6)


def test_affine_grid_matches_jax(rng):
    mats = rng.standard_normal((3, 2, 3)).astype(np.float32)
    want = jr.affine_grid(jnp.asarray(mats), (5, 7))
    got = tr.affine_grid(torch.from_numpy(mats), (5, 7))
    assert tuple(got.shape) == (3, 5, 7, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
