"""Paired and encode extraction of the PyTorch port against
livae_tpu.data.pipeline on the CPU.

The augmentation draws are derived exactly as the JAX package derives them
(kaug, kangle = split(key); _sample_aug(kaug); uniform(kangle)) and fed to the
port's explicit-draws entry point. Tolerance 1e-5: the same f32 resample
and shear arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.data import pipeline as jp
from livae_tpu_torch.data import pipeline as tp

PATCH, PAD = 32, 8
ATOL = 1e-5


@pytest.fixture
def frames(rng):
    """Two random frames, padded, and B sites (one beyond the pad margin, so
    the crop origin clamps)."""
    N, H, W, B = 2, 120, 140, 8
    raw = rng.random((N, H, W)).astype(np.float32)
    P2 = PATCH + 2 * PAD
    margin = (P2 + 16) // 2 + 8
    centers = np.stack([rng.uniform(0, H, B), rng.uniform(0, W, B)], axis=1).astype(np.float32)
    centers[0] = (-45.3, 7.6)
    img_idx = rng.integers(0, N, B).astype(np.int32)
    fp_j = jp.pad_frames(jnp.asarray(raw), margin)
    fp_t = tp.pad_frames(torch.from_numpy(raw), margin)
    np.testing.assert_array_equal(fp_t.numpy(), np.asarray(fp_j))
    return fp_j, fp_t, img_idx, centers, margin


def _jax_draws(key, B, cfg):
    """The draws _extract_batch_paired_impl makes from `key`, as PairedDraws."""
    kaug, kangle = jax.random.split(key)
    if cfg is not None:
        scale, _, fh, fv, jy, jx = jp._sample_aug(kaug, B, cfg)
    else:
        scale, fh, fv = jnp.ones((B,)), jnp.zeros((B,), bool), jnp.zeros((B,), bool)
        jy = jx = jnp.zeros((B,), jnp.int32)
    angle = jax.random.uniform(kangle, (B,), minval=0.0, maxval=2 * jnp.pi)
    t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(dt) if dt else torch.from_numpy(np.array(a))
    return tp.PairedDraws(t(scale), t(fh), t(fv), t(jy, torch.long), t(jx, torch.long), t(angle))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("cfg", [jp.AugmentConfig(), None], ids=["augment", "no_aug"])
@pytest.mark.parametrize("normalize", [True, False])
def test_paired_extraction_matches(frames, cfg, normalize):
    fp_j, fp_t, img_idx, centers, margin = frames
    key = jax.random.key(7)
    want = jp._extract_batch_paired_impl(
        fp_j, jnp.asarray(img_idx), jnp.asarray(centers), key, PATCH, PAD,
        cfg=cfg, margin=margin, normalize=normalize,
    )
    draws = _jax_draws(key, len(img_idx), cfg)
    got = tp.extract_batch_paired_with_draws(
        fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers), draws, PATCH, PAD,
        margin=margin, normalize=normalize,
    )
    for name, g, w in zip(("patch", "rotated"), got[:2], want[:2]):
        assert tuple(g.shape) == (len(img_idx), 1, PATCH, PATCH)
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_paired_extraction_bfloat16_rotation(frames):
    """rot_dtype=bfloat16: the rotated copy is bf16 on both sides; the patch
    stays f32. Tolerance one bf16 ulp at 1.0 (2^-7): the f32 shift deltas may
    round the other way at a bf16 boundary."""
    fp_j, fp_t, img_idx, centers, margin = frames
    key = jax.random.key(11)
    cfg = jp.AugmentConfig()
    want = jp._extract_batch_paired_impl(
        fp_j, jnp.asarray(img_idx), jnp.asarray(centers), key, PATCH, PAD,
        cfg=cfg, margin=margin, rot_dtype="bfloat16",
    )
    got = tp.extract_batch_paired_with_draws(
        fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers),
        _jax_draws(key, len(img_idx), cfg), PATCH, PAD, margin=margin, rot_dtype="bfloat16",
    )
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(_nhwc(got[1]), np.asarray(want[1], np.float32), atol=2**-7)


@pytest.mark.parametrize("normalize", [True, False])
def test_encode_extraction_matches(frames, normalize):
    fp_j, fp_t, img_idx, centers, margin = frames
    want = jp._extract_batch_impl(
        fp_j, jnp.asarray(img_idx), jnp.asarray(centers), None, PATCH, PAD,
        cfg=None, normalize=normalize, margin=margin,
    )
    got = tp.extract_batch(fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers),
                           PATCH, PAD, normalize=normalize, margin=margin)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_generator_draws_are_in_range():
    g = torch.Generator().manual_seed(0)
    d = tp.sample_paired_draws(4096, tp.AugmentConfig(), g, "cpu")
    assert 0.9 <= d.scale.min() and d.scale.max() <= 1.1
    assert d.jy.min() == -4 and d.jy.max() == 4
    assert 0.0 <= d.angle.min() and d.angle.max() <= 2 * np.pi
    assert 0.4 < d.flip_h.float().mean() < 0.6
