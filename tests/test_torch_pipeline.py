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


def _unpaired_draws(key, B, cfg):
    """The draws _extract_batch_impl makes from `key`, as PairedDraws."""
    scale, angle, fh, fv, jy, jx = (np.array(v) for v in jp._sample_aug(key, B, cfg))
    t = torch.from_numpy
    return tp.PairedDraws(t(scale), t(fh), t(fv), t(jy).long(), t(jx).long(), t(angle))


@pytest.mark.parametrize("rotation", [False, True], ids=["folded", "rotation"])
@pytest.mark.parametrize("normalize", [True, False])
def test_augmented_unpaired_extraction_matches(frames, rotation, normalize):
    """Augmented extract_batch against _extract_batch_impl with the draws of
    _sample_aug injected: flips and jitter folded into the grid, or, with
    cfg.rotation, scale/translate, then the rotation, then flips and roll."""
    fp_j, fp_t, img_idx, centers, margin = frames
    cfg_j = jp.AugmentConfig(rotation=rotation)
    key = jax.random.key(13)
    want = jp._extract_batch_impl(
        fp_j, jnp.asarray(img_idx), jnp.asarray(centers), key, PATCH, PAD,
        cfg=cfg_j, normalize=normalize, margin=margin,
    )
    draws = _unpaired_draws(key, len(img_idx), cfg_j)
    assert draws.flip_h.any() and draws.flip_v.any() and (draws.jy != 0).any()
    got = tp.extract_batch(
        fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers), PATCH, PAD,
        normalize=normalize, margin=margin, cfg=tp.AugmentConfig(rotation=rotation), draws=draws,
    )
    assert tuple(got.shape) == (len(img_idx), 1, PATCH, PATCH)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_rotation_config_without_draws_matches(frames):
    """cfg.rotation with no key: the identity draws, still through the
    rotation (by angle 0) and the flips-and-jitter stage."""
    fp_j, fp_t, img_idx, centers, margin = frames
    want = jp._extract_batch_impl(
        fp_j, jnp.asarray(img_idx), jnp.asarray(centers), None, PATCH, PAD,
        cfg=jp.AugmentConfig(rotation=True), normalize=True, margin=margin,
    )
    got = tp.extract_batch(fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers),
                           PATCH, PAD, margin=margin, cfg=tp.AugmentConfig(rotation=True))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_extract_batch_refuses_draws_without_cfg(frames):
    """Draws say nothing of the order in which to apply them: cfg does."""
    _, fp_t, img_idx, centers, margin = frames
    draws = _unpaired_draws(jax.random.key(13), len(img_idx), jp.AugmentConfig())
    with pytest.raises(ValueError, match="draws need the cfg"):
        tp.extract_batch(fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers),
                         PATCH, PAD, margin=margin, draws=draws)


def test_flips_and_jitter_is_flip_then_roll(rng):
    p = torch.from_numpy(rng.random((3, 6, 5)).astype(np.float32))
    fh = torch.tensor([True, False, True])
    fv = torch.tensor([False, True, True])
    jy, jx = torch.tensor([2, -1, 0]), torch.tensor([-3, 0, 4])
    got = tp._flips_and_jitter(p, fh, fv, jy, jx)
    for b in range(3):
        q = p[b]
        q = q.flip(1) if fh[b] else q
        q = q.flip(0) if fv[b] else q
        assert torch.equal(got[b], torch.roll(q, (int(jy[b]), int(jx[b])), (0, 1)))


def test_extract_batch_generator_augments_and_is_repeatable(frames):
    _, fp_t, img_idx, centers, margin = frames
    args = (fp_t, torch.from_numpy(img_idx).long(), torch.from_numpy(centers), PATCH, PAD)
    plain = tp.extract_batch(*args, margin=margin)
    cfg = tp.AugmentConfig(rotation=True)
    a = tp.extract_batch(*args, margin=margin, cfg=cfg,
                         generator=torch.Generator().manual_seed(3))
    b = tp.extract_batch(*args, margin=margin, cfg=cfg,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    # a generator without a cfg augments nothing
    assert torch.equal(tp.extract_batch(*args, margin=margin,
                                        generator=torch.Generator().manual_seed(3)), plain)


def test_generator_draws_are_in_range():
    g = torch.Generator().manual_seed(0)
    d = tp.sample_paired_draws(4096, tp.AugmentConfig(), g, "cpu")
    assert 0.9 <= d.scale.min() and d.scale.max() <= 1.1
    assert d.jy.min() == -4 and d.jy.max() == 4
    assert 0.0 <= d.angle.min() and d.angle.max() <= 2 * np.pi
    assert 0.4 < d.flip_h.float().mean() < 0.6
