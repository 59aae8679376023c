"""Dataset catalog: h5 path per (dataset_type, subject) + construction
(torch port's copy of anerf_tpu/data/catalog.py).

Mirrors reference core/load_data.py:22-143. Paths are relative to the
working directory, same layout as the reference's data/ tree.
`get_dataset_from_catalog(..., source=...)` builds from in-memory
`schema.H5Arrays` instead of the catalog's file (a machine without h5py).
"""
from __future__ import annotations

from typing import Optional

from ..config import TrainConfig

DATASET_CATALOG = {
    'h36m': {
        'S9': 'data/h36m/S9_processed_h5py.h5',
        'S9c': 'data/h36m/h36m_full/S9_60457274_processed_h5py.h5',
        'S11': 'data/h36m/S11_processed_h5py.h5',
        'S11c': 'data/h36m/h36m_full/S11_60457274_processed_h5py.h5',
    },
    'perfcap': {
        'weipeng': 'data/MonoPerfCap/Weipeng_outdoor/'
                   'Weipeng_outdoor_processed_h5py.h5',
        'nadia': 'data/MonoPerfCap/Nadia_outdoor/'
                 'Nadia_outdoor_processed_h5py.h5',
    },
    'surreal': {
        'female': 'data/surreal/surreal_train_h5py.h5',
    },
    'mixamo': {
        'james': 'data/mixamo/James_processed_h5py.h5',
        'archer': 'data/mixamo/Archer_processed_h5py.h5',
    },
    'zju': {k: f'data/zju_mocap/{k}_train_h5py.h5'
            for k in ['315', '377', '386', '387', '390', '392', '393',
                      '394']},
    '3dhp': {k: f'data/mpi_3dhp/{k}_processed_h5py.h5'
             for k in ['S1', 'S2', 'S3', 'S4', 'S5', 'S6']},
    # escape hatch: treat `subject` as a literal h5 path
    'h5': {},
}


def get_dataset_from_catalog(args: TrainConfig, n_samples: int,
                             dataset_type: str, subject: Optional[str] = None,
                             n_nms: float = 0, source=None):
    """The dataset of a catalog entry. `source` (an H5Arrays) stands in
    for the entry's h5 file; an H5Arrays without a path takes the
    catalog's, so the files beside it resolve as from the file."""
    from .dataset import BaseH5Dataset
    from .h36m import H36MDataset
    from .mixamo import MixamoDataset
    from .mpi3dhp import ThreeDHPDataset
    from .perfcap import MonoPerfCapDataset
    from .schema import H5Arrays
    from .surreal import SurrealDataset
    from .zju import ZJUMocapDataset

    split = 'full' if not args.use_val else 'train'
    shared = dict(N_samples=n_samples, split=split, mask_img=args.mask_image,
                  patch_size=args.patch_size, subject=subject, N_nms=n_nms,
                  multiview=args.multiview)
    refined = dict(load_refined=args.load_refined)

    if dataset_type == 'h5':
        return BaseH5Dataset(subject if source is None else source, **shared)
    path = DATASET_CATALOG[dataset_type][subject]
    if source is not None:
        if source.path is None:
            source = H5Arrays(source)
            source.path = path
        path = source
    if dataset_type == 'h36m':
        return H36MDataset(path, **shared, **refined)
    if dataset_type == 'perfcap':
        return MonoPerfCapDataset(path, **shared, **refined)
    if dataset_type == 'mixamo':
        return MixamoDataset(path, **shared, **refined)
    if dataset_type == 'surreal':
        shared['split'] = 'train'
        return SurrealDataset(path, N_cams=args.N_cams,
                              N_rand_kps=args.rand_train_kps, **shared)
    if dataset_type == 'zju':
        return ZJUMocapDataset(path, **shared)
    if dataset_type == '3dhp':
        return ThreeDHPDataset(path, **shared)
    raise NotImplementedError(f'dataset {dataset_type} is not implemented')
