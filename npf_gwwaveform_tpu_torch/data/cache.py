"""HDF5 chunk cache and the train/dev split of an image dataset, the
counterpart of `npf_gwwaveform_tpu/data/cache.py`.

`save_chunk` and `load_chunk` pin named arrays to an HDF5 file (optionally
under a group and a `chunk_{i}` subgroup), and `load_chunk` raises
`NotLoadedError` where the file or a key is absent, so that a caller
regenerates what is missing. h5py is imported inside those two functions
only: the module imports without it. `train_dev_split` splits a
`GridImageDataset` by `np.random.default_rng(seed).permutation`, the same
split index for index as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Union

import numpy as np

__all__ = ["NotLoadedError", "save_chunk", "load_chunk", "train_dev_split"]


class NotLoadedError(Exception):
    pass


def _resolve(save_file):
    if save_file is None:
        raise NotLoadedError("no save_file given")
    if isinstance(save_file, tuple):
        return save_file
    return save_file, None


def _prefix(group, idx_chunk) -> str:
    prefix = "" if group is None else f"{group}/"
    if idx_chunk is not None:
        prefix += f"chunk_{idx_chunk}/"
    return prefix


def save_chunk(to_save: Dict[str, np.ndarray], save_file, idx_chunk=None) -> None:
    """Save named arrays into an HDF5 file, `save_file` a path or (path,
    group), under `chunk_{idx_chunk}/` where given; an existing key is
    replaced. Does nothing when `save_file` is None."""
    if save_file is None:
        return
    import h5py

    path, group = _resolve(save_file)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prefix = _prefix(group, idx_chunk)
    with h5py.File(path, "a") as f:
        for name, arr in to_save.items():
            key = prefix + name
            if key in f:
                del f[key]
            f.create_dataset(key, data=np.asarray(arr))


def load_chunk(keys: Sequence[str], save_file, idx_chunk=None) -> Dict[str, np.ndarray]:
    """The named arrays `save_chunk` wrote; raises NotLoadedError where the
    file or a key is absent."""
    path, group = _resolve(save_file)
    if not os.path.exists(path):
        raise NotLoadedError(path)
    import h5py

    prefix = _prefix(group, idx_chunk)
    out = {}
    with h5py.File(path, "r") as f:
        for name in keys:
            key = prefix + name
            if key not in f:
                raise NotLoadedError(key)
            out[name] = f[key][()]
    return out


def train_dev_split(dataset, dev_size: Union[int, float] = 0.1, seed: int = 0):
    """(train, dev) `GridImageDataset`s of a dataset's images: the first
    `dev_size` (a count, or a fraction of the images) of
    `np.random.default_rng(seed).permutation` go to dev, the rest to train,
    in that order. The JAX package seeds each subset's own key with `seed`
    and `seed + 1`; the port's datasets draw their orders from the
    generator a caller passes."""
    from .images import GridImageDataset

    n = len(dataset)
    n_dev = int(dev_size * n) if isinstance(dev_size, float) else dev_size
    order = np.random.default_rng(seed).permutation(n)
    imgs = np.asarray(dataset.images)
    return GridImageDataset(imgs[order[n_dev:]]), GridImageDataset(imgs[order[:n_dev]])
