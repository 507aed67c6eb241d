"""rotate_image_fast, center_crop and _rot90_select of the PyTorch port
against livae_tpu.ops.resample on the CPU (NHWC <-> NCHW)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.ops import resample as jr
from livae_tpu_torch.ops import resample as tr

THETAS = np.array([0.3, -1.2, 2.0, 3.5, -2.9, 0.0, np.pi / 4, -0.05], np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("padding_mode", ["reflection", "zeros"])
@pytest.mark.parametrize("margin", [None, 32 // 6])
def test_rotate_image_fast_values_and_gradients(rng, padding_mode, margin):
    """Values at 1e-5 (same f32 shear arithmetic; tan/sin may differ in the
    last ulp between the libraries). Gradients: the image at 1e-5; theta at
    rtol 1e-4 / atol 1e-3, a sum over every pixel of the canvas."""
    S = 32
    img = rng.random((len(THETAS), S, S, 1)).astype(np.float32)
    w = rng.standard_normal(img.shape).astype(np.float32)

    def jfun(im, th):
        return jr.rotate_image_fast(im, th, padding_mode, margin=margin, backend="xla")

    want = jax.jit(jfun)(jnp.asarray(img), jnp.asarray(THETAS))
    gj = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * jfun(a, b)), argnums=(0, 1)))(
        jnp.asarray(img), jnp.asarray(THETAS))

    it = _nchw(img).requires_grad_(True)
    tt = torch.from_numpy(THETAS).requires_grad_(True)
    got = tr.rotate_image_fast(it, tt, padding_mode, margin=margin)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    gi, gth = torch.autograd.grad((_nchw(w) * got).sum(), (it, tt))
    np.testing.assert_allclose(_nhwc(gi), np.asarray(gj[0]), atol=1e-5)
    np.testing.assert_allclose(gth.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-3)


def test_rotate_image_fast_keeps_bfloat16(rng):
    img = rng.random((4, 32, 32, 1)).astype(np.float32)
    th = THETAS[:4]
    want = jax.jit(lambda a, b: jr.rotate_image_fast(a, b, "reflection", backend="xla"))(
        jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(th))
    got = tr.rotate_image_fast(_nchw(img).bfloat16(), torch.from_numpy(th), "reflection")
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at 1.0: the shift deltas may differ in their last f32 ulp
    np.testing.assert_allclose(_nhwc(got.float()), np.asarray(want, np.float32), atol=2**-7)


@pytest.mark.parametrize("size", [(16, 16), (20, 12), (40, 44), (7, 9)])
def test_center_crop_exact(rng, size):
    img = rng.random((2, 33, 30, 1)).astype(np.float32)
    want = jr.center_crop(jnp.asarray(img), size)
    got = tr.center_crop(_nchw(img), size)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_rot90_select_exact(rng):
    img = rng.random((6, 16, 16, 1)).astype(np.float32)
    q = np.array([0, 1, 2, 3, -1, 5], np.int32)
    want = jr._rot90_select(jnp.asarray(img), jnp.asarray(q))
    got = tr._rot90_select(_nchw(img), torch.from_numpy(q).long())
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_aligned_margin_and_rotation_matrix():
    for s in (32, 64, 128, 192):
        assert tr.aligned_margin(s) == jr.aligned_margin(s)
    c, s = np.cos(THETAS), np.sin(THETAS)
    np.testing.assert_array_equal(
        tr.rotation_matrix(torch.from_numpy(c), torch.from_numpy(s)).numpy(),
        np.asarray(jr.rotation_matrix(jnp.asarray(c), jnp.asarray(s))),
    )
