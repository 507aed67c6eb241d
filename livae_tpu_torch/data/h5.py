"""HDF5 frame I/O on the host (a copy of livae_tpu/data/h5.py).

Exact-path lookup, then a basename search via visititems, then 2D
auto-detection preferring the basenames {image, data, HAADF} and after them
the largest area. `h5py` is imported inside the function: only a run that
loads .h5 frames needs it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["load_image_from_h5"]


def load_image_from_h5(
    file_path: Path | str,
    dataset_name: str | None = None,
) -> np.ndarray:
    """Load a 2D image from an HDF5 file (see module docstring)."""
    import h5py

    file_path = Path(file_path)

    with h5py.File(file_path, "r") as h5_file:
        dset_path: str | None = None

        if dataset_name is not None:
            if dataset_name in h5_file:
                dset_path = dataset_name
            else:
                target_base = Path(dataset_name).name
                candidates: list[str] = []

                def _collect(name, obj):
                    if isinstance(obj, h5py.Dataset) and Path(name).name == target_base:
                        candidates.append(name)

                h5_file.visititems(_collect)
                if candidates:
                    dset_path = candidates[0]

        if dset_path is None:
            datasets: list[tuple[str, tuple[int, ...]]] = []

            def _gather(name, obj):
                if isinstance(obj, h5py.Dataset):
                    datasets.append((name, tuple(int(s) for s in obj.shape)))

            h5_file.visititems(_gather)

            two_d = [(n, s) for n, s in datasets if len(s) == 2]
            if not two_d:
                raise KeyError(f"No 2D datasets found in HDF5 file: {file_path}")

            preferred = {"image", "data", "HAADF"}

            def score(item):
                name, shape = item
                return (1 if Path(name).name in preferred else 0, shape[0] * shape[1])

            two_d.sort(key=score, reverse=True)
            dset_path = two_d[0][0]

        return np.asarray(h5_file[dset_path][:])
