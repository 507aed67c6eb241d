"""Device peak detection of the PyTorch port against livae_tpu's jitted
versions, on the CPU: the NMS table (`peak_local_max_device` against
`peak_local_max_tpu`), the 5x5 refinement, the two together, the growing
table of `detect_atoms_device`, and `build_adaptive_lattice(device_peaks=True)`.

Coordinates and validity masks are integers and booleans, so they must be
equal; the site tables are held at atol 1e-9 (they come out equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livae_tpu.data.synthetic import synthetic_mos2_frame as jax_frame
from livae_tpu.ops import lattice as jl
from livae_tpu.ops import peaks as jp
from livae_tpu.ops.fft import bandpass_filter as jax_bandpass
from livae_tpu.ops.fft import normalize_image as jax_normalize
from livae_tpu_torch.ops import lattice as tl
from livae_tpu_torch.ops import peaks as tp


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lattice_img():
    """The bandpassed synthetic frame of tests/test_lattice.py's device-peaks test."""
    frame, _ = jax_frame(size=512, spacing=20.0, seed=5)
    return np.asarray(jax_normalize(jax_bandpass(frame, 5, 64)))


def _plateaus(rng):
    """Equal-valued 3x3 plateaus on a quantised background: many exact ties
    among the NMS survivors, so the table's order among equal scores shows."""
    img = np.round(rng.random((64, 80)) * 4) / 8
    for r in range(6, 60, 9):
        for c in range(6, 76, 9):
            img[r - 1 : r + 2, c - 1 : c + 2] = 1.0
    return img.astype(np.float32)


def _images(lattice_img):
    rng = np.random.default_rng(0)
    return {"lattice": lattice_img.astype(np.float32), "plateaus": _plateaus(rng),
            "noise": rng.random((48, 40)).astype(np.float32)}


CASES = [  # (image, min_distance, threshold_rel, max_peaks, exclude_border)
    ("lattice", 3, 0.01, 4096, True),
    ("lattice", 3, 0.3, 64, True),  # saturated: fewer slots than peaks
    ("plateaus", 2, 0.01, 512, True),
    ("plateaus", 1, 0.01, 100, False),  # ties cut by the table's end
    ("noise", 1, 0.5, 32, True),
    ("noise", 4, 0.0, 200, False),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-md{c[1]}-k{c[3]}" for c in CASES])
def test_peak_local_max_device_equals_jax(lattice_img, case):
    name, md, thr, k, border = case
    img = _images(lattice_img)[name]
    coords, valid = tp.peak_local_max_device(img, md, thr, k, border, device="cpu")
    jc, jv = jp.peak_local_max_tpu(jnp.asarray(img), md, thr, k, border)
    assert coords.dtype == torch.int32 and coords.shape == (k, 2)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jc))
    if name != "noise" or k == 32:
        assert valid.any()


def test_ties_keep_the_lower_flat_index_first(lattice_img):
    """Every plateau pixel that survives NMS has the same score: XLA's top_k
    lists them by flat index, and so must the port."""
    img = _images(lattice_img)["plateaus"]
    coords, valid = tp.peak_local_max_device(img, 1, 0.01, 400, False, device="cpu")
    c = coords.numpy()[valid.numpy()]
    top = img[c[:, 0], c[:, 1]] == 1.0
    flat = c[top, 0] * img.shape[1] + c[top, 1]
    assert top.sum() > 50 and np.all(np.diff(flat) > 0)


@pytest.mark.parametrize("name", ["lattice", "plateaus", "noise"])
def test_refine_and_detect_equal_jax(lattice_img, name):
    """The refinement of every table row (border rows too: exclude_border
    off), then detect_peaks_device as a whole."""
    img = _images(lattice_img)[name]
    coords, valid = tp.peak_local_max_device(img, 2, 0.01, 256, False, device="cpu")
    jc, jv = jp.peak_local_max_tpu(jnp.asarray(img), 2, 0.01, 256, False)
    got = tp.refine_peaks_device(torch.from_numpy(img), coords, valid)
    want = jp.refine_peaks_tpu(jnp.asarray(img), jc, jv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rc, rv = tp.detect_peaks_device(img, 3, 0.05, 128, device="cpu")
    jrc, jrv = jp.detect_peaks_tpu(jnp.asarray(img), 3, 0.05, 128)
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))
    assert tp.detect_peaks_tpu is tp.detect_peaks_device


@pytest.mark.parametrize("shape,md,thr", [((512, 512), 3, 0.01), ((440, 440), 1, 0.0)],
                         ids=["lattice", "grows"])
def test_detect_atoms_device_equals_jax(lattice_img, shape, md, thr):
    """The lattice frame, and noise with min_distance 1: about 21,000 maxima
    fill the first table of 16384 rows, which then grows fourfold. Both in
    float32, the precision JAX ranks in."""
    if shape == lattice_img.shape:
        img = lattice_img
    else:
        img = np.random.default_rng(1).random(shape).astype(np.float32)
    got = tl.detect_atoms_device(img, md, thr, device="cpu")
    want = jl.detect_atoms_device(img, md, thr)
    assert got.dtype == np.float64 and len(got) > 100
    np.testing.assert_array_equal(got, want)
    if md == 1:
        assert len(got) > 16384


def test_build_adaptive_lattice_device_peaks_equals_jax(lattice_img):
    got = tl.build_adaptive_lattice(lattice_img, 64, 16, device_peaks=True, device="cpu")
    want = jl.build_adaptive_lattice(lattice_img, patch_size=64, padding=16, device_peaks=True)
    assert got[2] == pytest.approx(want[2], abs=1e-9)
    assert len(got[0]) == len(want[0]) > 50
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int64


@pytest.mark.parametrize("size,spacing", [(512, 20.0), (1024, 40.0)])
def test_device_build_equals_host_build_on_a_float64_frame(size, spacing):
    """A float64 frame (the datasets' preprocessing) is ranked in float64 on
    the device: the atoms come out as get_clean_peaks gives them, in its
    order, and so the site table is the host build's, row for row. In
    float32 (JAX's ranking) close intensities swap, which moves a few
    nearest-neighbour lattice vectors and so a few deduped sites."""
    from livae_tpu_torch.data.synthetic import synthetic_mos2_frame
    from livae_tpu_torch.ops.fft import host_bandpass_normalize

    img = host_bandpass_normalize(synthetic_mos2_frame(size=size, spacing=spacing, seed=0)[0],
                                  20, 100)
    assert img.dtype == np.float64
    spacing = tl.estimate_lattice_constant(img, device="cpu")
    md = int(spacing * 0.15)
    np.testing.assert_array_equal(tl.detect_atoms_device(img, md, device="cpu"),
                                  tp.get_clean_peaks(img, min_distance=md))
    host = tl.build_adaptive_lattice(img, 128, 32, lattice_spacing=spacing, device="cpu")
    dev = tl.build_adaptive_lattice(img, 128, 32, lattice_spacing=spacing, device_peaks=True,
                                    device="cpu")
    assert len(dev[0]) > 100
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], host[1])
