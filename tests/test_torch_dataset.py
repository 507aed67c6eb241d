"""The PyTorch port's site table against livae_tpu's, on the bench frame
(synthetic_mos2_frame(size=1024, spacing=40.0, seed=0), patch 128, padding 32):
the same lattice constant, count, coordinates, labels and padded frames."""

import numpy as np
import pytest
import torch

from livae_tpu.data.datasets import PairedAdaptiveLatticeDataset as JaxDataset
from livae_tpu.data.synthetic import synthetic_mos2_frame as jax_frame
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
