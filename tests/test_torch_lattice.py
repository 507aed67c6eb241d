"""The rest of the port's lattice module against livae_tpu.ops.lattice on the
CPU: `radial_profile` against `radial_profile_tpu` at 1e-4 relative (float32
FFTs of two libraries), and both call forms of `generate_lattice_grid`
(numpy over the same clustering) exactly."""

import numpy as np
import pytest
import torch

from livae_tpu.data.synthetic import hexagonal_wave_image
from livae_tpu.ops import lattice as jl
from livae_tpu_torch.ops import lattice as tl


@pytest.mark.parametrize("size,spacing", [(128, 10.0), (256, 16.0)])
def test_radial_profile_equals_jax(size, spacing):
    torch.set_num_threads(1)
    img = hexagonal_wave_image(size=size, spacing=spacing, noise=0.1)
    got = tl.radial_profile(img, device="cpu")
    want = jl.radial_profile_tpu(img)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    assert tl.radial_profile_tpu is tl.radial_profile


@pytest.mark.parametrize("shape,spacing,offset", [((100, 100), 10.0, (0, 0)),
                                                  ((64, 90), 7.5, (2.0, 3.5))])
def test_hex_grid_equals_jax(shape, spacing, offset):
    got = tl.generate_lattice_grid(shape, spacing, offset)
    np.testing.assert_array_equal(got, jl.generate_lattice_grid(shape, spacing, offset))
    assert got.shape[1] == 2 and len(got) > 20


GRID_COORDS = {
    "square": np.array([[10, 10], [10, 20], [10, 30], [20, 10], [20, 20], [20, 30],
                        [30, 10], [30, 20], [30, 30]], dtype=float),
    "one": np.array([[10.0, 10.0]]),
    "two": np.array([[10.0, 10.0], [20.0, 20.0]]),
    "collinear": np.array([[10.0, 10.0], [10.0, 20.0], [10.0, 30.0]]),
    "edges": np.array([[8, 8], [8, 40], [40, 8], [40, 40], [24, 24]], dtype=float),
}


@pytest.mark.parametrize("name", sorted(GRID_COORDS))
@pytest.mark.parametrize("crop", [{}, {"patch_size": 32, "padding": 4}])
def test_atom_anchored_grid_equals_jax(name, crop):
    coords = GRID_COORDS[name]
    shape = (48, 48) if name == "edges" else (50, 50)
    got = tl.generate_lattice_grid(coords, shape, **crop)
    want = jl.generate_lattice_grid(coords, shape, **crop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl.extrapolate_lattice_grid(coords, shape, **crop), want)
