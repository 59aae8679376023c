"""The h5 dataset schema: reader / writer of the reference's layout (torch
port's copy of anerf_tpu/data/schema.py).

The reference stores preprocessed datasets as a single .h5 with images
flattened to (N, H*W, C) and chunked for fast pixel indexing
(core/process_spin.py:234-296). Files written here load in the JAX
package and in the reference.

Keys: img_shape (4,), imgs/masks (N, H*W, C) uint8 chunked,
sampling_masks (N, H*W, 1) whole-image chunks, bkgds (N_bg, H*W, 3),
bkgd_idxs (N,), kp3d/gt_kp3d (N_kp, J, 3), bones (N_kp, J, 3),
skts (N_kp, J, 4, 4), cyls (N_kp, 5), rest_pose (J, 3), betas (1, 10),
c2ws (N, 4, 4), focals (N,) [optional centers (N, 2)], ext_scale ().

`h5_arrays` gives the same keys, shapes and dtypes as numpy arrays in
memory: the datasets read it wherever they take an h5 path, so a machine
without h5py can still train from a fixture's arrays. h5py is imported
only where a file is written or read. An H5Arrays may name the path its
file would have (`path`): the files a dataset finds beside its h5
(Mixamo's selected.npy, ZJU's and SURREAL's other splits) resolve from it,
as they do from the file's own path (`source_path`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

IMG_TO_CHUNK = ('imgs', 'bkgds', 'masks')
IMG_TO_KEEP_WHOLE = ('sampling_masks',)
_REDUNDANT = ('index', 'img_path')


class H5Arrays(dict):
    """A dataset file's contents held as numpy arrays: a mapping with the
    h5py.File calls the datasets make (`keys`, `in`, `[key]`, `with`,
    `close`). `path` is where the file these arrays stand for would lie,
    or None.

    `[key]` reads as h5py reads a file: the small tables as a copy (the
    datasets change what they read in place, as MonoPerfCap's camera fix
    does), the pixel tables as read-only views (too large to copy on
    every per-item read; nothing writes them)."""

    path = None

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if key in IMG_TO_CHUNK or key in IMG_TO_KEEP_WHOLE:
            v = v.view()
            v.flags.writeable = False
            return v
        return v.copy()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass


def h5_arrays(data: Dict[str, np.ndarray],
              path: Optional[str] = None) -> H5Arrays:
    """A dataset dict in the stored layout: what reading back
    write_h5(data) returns, key for key (images flattened to (N, H*W, C),
    other floats float32, other integers int64, scalars as they are).
    `path` names where its file would lie (H5Arrays.path)."""
    imgs = data['imgs']
    H, W = imgs.shape[1:3]
    out = H5Arrays(img_shape=np.array(imgs.shape, np.int32))
    out.path = path
    for k, v in data.items():
        if k in _REDUNDANT:
            continue
        if not isinstance(v, Iterable):
            out[k] = np.array(v, dtype=type(v))
            continue
        v = np.asarray(v)
        if k in IMG_TO_CHUNK or k in IMG_TO_KEEP_WHOLE:
            out[k] = v.reshape(v.shape[0], H * W, v.shape[-1])
        elif k == 'img_paths':
            out[k] = v.astype('S')
        elif np.issubdtype(v.dtype, np.floating):
            out[k] = v.astype(np.float32)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = v.astype(np.int64)
        else:
            raise NotImplementedError(f'unknown dtype for {k}: {v.dtype}')
    return out


def write_h5(filename: str, data: Dict[str, np.ndarray],
             img_chunk_size: int = 64, compression: str = 'gzip') -> None:
    """Write a dataset dict to the canonical h5 layout."""
    import h5py

    H, W = data['imgs'].shape[1:3]
    chunk = (1, min(int(img_chunk_size ** 2), H * W))
    whole = (1, H * W)
    with h5py.File(filename, 'w') as f:
        for k, v in h5_arrays(data).items():
            if v.ndim == 0:
                ds = f.create_dataset(k, (), v.dtype)
                ds[()] = v
            elif k in IMG_TO_CHUNK or k in IMG_TO_KEEP_WHOLE:
                data_chunk = (chunk if k in IMG_TO_CHUNK else whole) \
                    + (v.shape[-1],)
                ds = f.create_dataset(k, v.shape, v.dtype, chunks=data_chunk,
                                      compression=compression)
                for i in range(v.shape[0]):
                    ds[i] = v[i]
            elif k in ('img_shape', 'img_paths'):
                f.create_dataset(k, data=v)
            else:
                f.create_dataset(k, data=v, compression=compression)


def open_h5(source):
    """An open dataset: `source` is an h5 path (opened read-only with
    h5py, swmr as every open of the file in the process) or an H5Arrays
    mapping, returned as it is."""
    if isinstance(source, H5Arrays):
        return source
    import h5py
    return h5py.File(source, 'r', swmr=True)


def source_path(source) -> str:
    """The path of a dataset's h5: `source` itself, or an H5Arrays'
    `path`. The files found beside the h5 resolve from it."""
    if isinstance(source, H5Arrays):
        if source.path is None:
            raise ValueError('these in-memory arrays name no file path '
                             '(h5_arrays(..., path=...)); the dataset '
                             'looks for a file beside it')
        return source.path
    return source


def dataset_keys(source):
    with open_h5(source) as f:
        return list(f.keys())
