"""The PyTorch port's site table against livae_tpu's, on the bench frame
(synthetic_mos2_frame(size=1024, spacing=40.0, seed=0), patch 128, padding 32):
the same lattice constant, count, coordinates, labels and padded frames; and
the unpaired datasets (AdaptiveLatticeDataset, PatchDataset) on a 512-pixel
frame at patch 32, padding 8."""

import numpy as np
import pytest
import torch

from livae_tpu.data import datasets as jd
from livae_tpu.data.datasets import PairedAdaptiveLatticeDataset as JaxDataset
from livae_tpu.data.synthetic import synthetic_mos2_frame as jax_frame
from livae_tpu_torch.data import datasets as td
from livae_tpu_torch.data.datasets import PairedAdaptiveLatticeDataset
from livae_tpu_torch.data.synthetic import synthetic_mos2_frame


@pytest.fixture(scope="module")
def pair():
    frame, _ = synthetic_mos2_frame(size=1024, spacing=40.0, seed=0)
    np.testing.assert_array_equal(frame, jax_frame(size=1024, spacing=40.0, seed=0)[0])
    ours = PairedAdaptiveLatticeDataset([frame], patch_size=128, padding=32, device="cpu")
    ref = JaxDataset([frame], patch_size=128, padding=32)
    return ours, ref


def test_site_table_equals_livae_tpu(pair):
    ours, ref = pair
    assert len(ours) == len(ref) == 1409
    assert int((ours.labels[0] == 1).sum()) == 1180
    assert ours.lattice_spacings == ref.lattice_spacings
    np.testing.assert_array_equal(ours._coords_flat, ref._coords_flat)
    np.testing.assert_array_equal(ours._img_idx, ref._img_idx)
    np.testing.assert_array_equal(ours.labels[0], ref.labels[0])
    frames_padded, img_idx, coords, margin = ours.device_site_table
    assert margin == ref._margin
    np.testing.assert_array_equal(frames_padded.numpy(), np.asarray(ref.frames_padded))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref._coords_dev))


def test_epoch_batches_and_batch_at(pair):
    ours, _ = pair
    g = torch.Generator().manual_seed(0)
    idx = ours.epoch_index_batches(g, 512)
    assert tuple(idx.shape) == (2, 512)
    assert len(set(idx.reshape(-1).tolist())) == 1024
    patch, rotated, angle = ours.batch_at(idx[0, :4], g)
    assert tuple(patch.shape) == tuple(rotated.shape) == (4, 1, 128, 128)
    assert tuple(angle.shape) == (4,)
    assert float(patch.min()) == 0.0 and float(patch.max()) == 1.0


@pytest.fixture(scope="module")
def small_frame():
    return synthetic_mos2_frame(size=512, spacing=40.0, seed=1)[0]


@pytest.fixture(scope="module", params=["adaptive", "patch"])
def unpaired(request, small_frame):
    if request.param == "adaptive":
        kw = dict(patch_size=32, padding=8)
        return (td.AdaptiveLatticeDataset([small_frame], device="cpu", **kw),
                jd.AdaptiveLatticeDataset([small_frame], **kw))
    kw = dict(patch_size=32)  # the default padding of 4
    return td.PatchDataset([small_frame], device="cpu", **kw), jd.PatchDataset([small_frame], **kw)


def test_unpaired_site_tables_equal_livae_tpu(unpaired):
    """Same count; coordinates at 1e-6 (they come out equal)."""
    ours, ref = unpaired
    assert len(ours) == len(ref) > 100
    assert ours.lattice_spacings == ref.lattice_spacings
    np.testing.assert_allclose(ours._coords_flat, ref._coords_flat, atol=1e-6)
    np.testing.assert_array_equal(ours._img_idx, ref._img_idx)
    assert ours._margin == ref._margin and ours.padding == ref.padding
    frames_padded, img_idx, coords, margin = ours.device_site_table
    np.testing.assert_array_equal(frames_padded.numpy(), np.asarray(ref.frames_padded))
    assert ours.transform == td.AugmentConfig(rotation=ref.transform.rotation)
    assert ours._NORMALIZE == ref._NORMALIZE


def test_unpaired_index_error_and_getitem(unpaired):
    ours, _ = unpaired
    for bad in (-1, len(ours)):
        with pytest.raises(IndexError, match="out of range for dataset of size"):
            ours[bad]
    item = ours[3]
    assert item.shape == (1, 32, 32) and item.dtype == np.float32


def test_unpaired_batch_at_without_augmentation_matches(unpaired):
    """batch_at(indices) with no generator is the un-augmented extraction on
    both sides, at 1e-5 (the same f32 resample arithmetic)."""
    ours, ref = unpaired
    idx = np.arange(0, len(ours), max(1, len(ours) // 16))[:16]
    got = ours.batch_at(idx)
    want = np.asarray(ref.batch_at(idx))
    assert tuple(got.shape) == (len(idx), 1, 32, 32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


def test_unpaired_samplers(unpaired):
    ours, _ = unpaired
    g = torch.Generator().manual_seed(2)
    assert tuple(ours.sample_batch(g, 8).shape) == (8, 1, 32, 32)
    batches = list(ours.iter_epoch(g, 64))
    assert len(batches) == len(ours) // 64 and tuple(batches[0].shape) == (64, 1, 32, 32)
    assert len(list(ours.iter_epoch(g, 64, drop_last=False))) == -(-len(ours) // 64)
    idx = ours.epoch_index_batches(g, 64)
    assert tuple(idx.shape) == (len(ours) // 64, 64)
    plain = ours.batch_at(idx[0])
    assert not torch.equal(ours.batch_at(idx[0], g), plain)  # a generator augments


def test_patch_dataset_forces_rotation_and_skips_the_minmax(small_frame):
    ds = td.PatchDataset([small_frame], patch_size=32, device="cpu",
                         transform=td.AugmentConfig(jitter=2))
    assert ds.transform == td.AugmentConfig(jitter=2, rotation=True)
    assert td.default_transform.rotation is False  # the shared default is not changed
    assert ds._NORMALIZE is False and ds.atom_coords is ds.sample_coords
    x = ds.batch_at(np.arange(8))
    assert not (float(x.min()) == 0.0 and float(x.max()) == 1.0)  # no per-patch min-max
    half = 32 // 2 + 4  # edge exclusion at patch_size // 2 + padding
    c = ds._coords_flat
    assert c.min() >= half and c.max() <= 512 - half
    assert td.PatchDataset([small_frame], patch_size=32, transform=None,
                           device="cpu").transform is None
    with pytest.raises(TypeError, match="AugmentConfig"):
        td.PatchDataset([small_frame], patch_size=32, transform=lambda x: x, device="cpu")


def test_patch_dataset_plot_peaks(small_frame, tmp_path):
    ds = td.PatchDataset([small_frame], patch_size=32, device="cpu")
    out = tmp_path / "peaks.png"
    ds.plot_peaks(0, size=256, offset=(64, 64), save_path=str(out))
    assert out.stat().st_size > 1000


def test_device_peaks_equals_host_build(small_frame):
    """device_peaks=True builds the same sites and labels as the host build
    (as lexsorted sets: the atoms come in another order), and the same table
    as livae_tpu's device_peaks=True, in its order."""
    kw = dict(patch_size=32, padding=8)
    dev = td.AdaptiveLatticeDataset([small_frame], device_peaks=True, device="cpu", **kw)
    host = td.AdaptiveLatticeDataset([small_frame], device="cpu", **kw)
    ref = jd.AdaptiveLatticeDataset([small_frame], device_peaks=True, **kw)
    assert dev.device_peaks and len(dev) == len(host) > 100

    def table(ds):
        sites, labels = ds.sample_coords[0], ds.labels[0]
        order = np.lexsort((sites[:, 1], sites[:, 0]))
        return sites[order], labels[order]

    for got, want in zip(table(dev), table(host)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dev._coords_flat, ref._coords_flat)
    np.testing.assert_array_equal(dev.labels[0], ref.labels[0])


def test_paired_dataset_is_an_adaptive_lattice_dataset(pair):
    ours, _ = pair
    assert isinstance(ours, td.AdaptiveLatticeDataset) and ours.normalize is True
    a = ours.batch_at([0, 5])  # no generator: a fixed stream, as the JAX package's key(0)
    b = ours.batch_at([0, 5])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    patch, rotated, angle = ours[7]
    assert patch.shape == rotated.shape == (1, 128, 128) and 0.0 <= angle <= 2 * np.pi
    with pytest.raises(IndexError):
        ours[len(ours)]
