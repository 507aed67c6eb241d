"""The port's device filters (livae_tpu_torch.ops.fft) against
livae_tpu.ops.fft on the CPU, at rtol = atol = 1e-5 (float32 FFTs of two
libraries: pocketfft in torch, Eigen's in XLA), on 17x23 (odd, unequal sides)
and 64x64 images.

The phase of a near-zero frequency is rounding noise on either side, so it is
held only where the magnitude exceeds 1e-3 of its maximum, and modulo 2 pi.
An FFT's rounding error is relative to the spectrum's largest term, not to
each term, so the phase is held as an arc: |d phase| x |F| within 1e-5 of
max |F| (the largest difference seen was 1.4e-5 rad, at a term near 1e-3 of
the maximum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.ops import fft as jf
from livae_tpu_torch.ops import fft as tf

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(17, 23), (64, 64)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    y, x = np.mgrid[: shape[0], : shape[1]]
    waves = np.cos(2 * np.pi * x / 5.0) + np.cos(2 * np.pi * (x + y) / 7.0)
    return (waves + 0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("low,high", [(0.0, None), (2.0, None), (0.0, 5.5), (3.0, 9.0)])
def test_radial_mask_equals_jax(shape, low, high):
    got = tf.radial_mask(shape, low, high, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.radial_mask(shape, low, high)))


@pytest.mark.parametrize("shape", SHAPES)
def test_fft_spectra_equal_jax(shape):
    img = _image(shape)
    mag, phase = tf.fft_spectra(img, device="cpu")
    jmag, jphase = (np.asarray(a) for a in jf.fft_spectra(img))
    np.testing.assert_allclose(mag.numpy(), jmag, **TOL)
    held = jmag > 1e-3 * jmag.max()
    diff = np.angle(np.exp(1j * (phase.numpy()[held] - jphase[held])))  # modulo 2 pi
    assert held.mean() > 0.5
    assert np.abs(diff * jmag[held]).max() <= 1e-5 * jmag.max()


@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_image_equals_jax(shape):
    img = _image(shape) * 3.0 + 1.0
    got = tf.normalize_image(img, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.normalize_image(img)), **TOL)
    assert float(got.min()) == 0.0 and float(got.max()) == 1.0
    flat = tf.normalize_image(torch.full(shape, 2.5))
    assert flat.dtype == torch.float32 and not flat.any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,args", [("lowpass_filter", (4.0,)), ("highpass_filter", (3.0,)),
                                       ("bandpass_filter", (2.0, 8.0))])
def test_filters_equal_jax(shape, name, args):
    img = _image(shape)
    got = getattr(tf, name)(img, *args, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jf, name)(img, *args)), **TOL)
    # a tensor stays where it is, and gives the same values
    again = getattr(tf, name)(torch.from_numpy(img), *args)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_value_errors_as_in_jax():
    img = _image((17, 23))
    for bad in (img[0], img[None], torch.zeros(2, 3, 4)):
        for fn in (lambda a: tf.fft_spectra(a, device="cpu"),
                   lambda a: tf.lowpass_filter(a, 3.0, device="cpu"),
                   lambda a: tf.highpass_filter(a, 3.0, device="cpu"),
                   lambda a: tf.bandpass_filter(a, 1.0, 3.0, device="cpu")):
            with pytest.raises(ValueError, match="Expected a 2D array"):
                fn(bad)
    for low, high in ((5.0, 5.0), (6.0, 2.0)):
        with pytest.raises(ValueError, match="high_cutoff must be greater"):
            tf.bandpass_filter(img, low, high, device="cpu")
        with pytest.raises(ValueError, match="high_cutoff must be greater"):
            jf.bandpass_filter(jnp.asarray(img), low, high)
