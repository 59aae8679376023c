"""Dataset catalog: h5 path per (dataset_type, subject) + construction
(torch port's copy of anerf_tpu/data/catalog.py).

Mirrors reference core/load_data.py:22-143. Paths are relative to the
working directory, same layout as the reference's data/ tree. The port
builds the 'h5' and 'surreal' types; the others raise until their dataset
classes are ported (ROADMAP.md Queue 1 item 4, the other dataset types).
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

#: the JAX package's dataset classes for the types the port does not build
UNPORTED = {'h36m': 'H36MDataset', 'perfcap': 'MonoPerfCapDataset',
            'mixamo': 'MixamoDataset', 'zju': 'ZJUMocapDataset',
            '3dhp': 'ThreeDHPDataset'}


def get_dataset_from_catalog(args: TrainConfig, n_samples: int,
                             dataset_type: str, subject: Optional[str] = None,
                             n_nms: float = 0):
    from .dataset import BaseH5Dataset
    from .surreal import SurrealDataset

    split = 'full' if not args.use_val else 'train'
    shared = dict(N_samples=n_samples, split=split, mask_img=args.mask_image,
                  patch_size=args.patch_size, subject=subject, N_nms=n_nms,
                  multiview=args.multiview)

    if dataset_type == 'h5':
        return BaseH5Dataset(subject, **shared)
    if dataset_type in UNPORTED:
        raise NotImplementedError(
            f'dataset type {dataset_type!r} ({UNPORTED[dataset_type]}) is '
            f'not ported yet (ROADMAP.md Queue 1 item 4, the other dataset '
            f'types); the port builds the h5 and surreal types')
    if dataset_type == 'surreal':
        shared['split'] = 'train'
        return SurrealDataset(DATASET_CATALOG['surreal'][subject],
                              N_cams=args.N_cams,
                              N_rand_kps=args.rand_train_kps, **shared)
    raise NotImplementedError(f'dataset {dataset_type} is not implemented')
