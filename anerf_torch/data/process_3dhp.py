"""Offline MPI-INF-3DHP raw -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_3dhp.py).

Re-design of reference core/load_3dhp.py:82-141 (process_3dhp_data): SPIN
estimates from the MPI_SPIN packs + per-frame images/masks + a static
background plate -> canonical h5 read by ThreeDHPDataset. Requires the raw
release on disk; checked against the JAX package's converter on the
synthetic raw layouts of tests/rawlayout.py.
"""
from __future__ import annotations

import os

import numpy as np

from .process_mask import dilate_masks
from .process_spin import read_spin_data
from .schema import write_h5

# native per-subject image resolutions (load_3dhp.py:15-22)
RES_MAP = {
    'S1': (768, 768), 'S2': (768, 768), 'S3': (768, 768),
    'S4': (768, 768), 'S5': (768, 1365), 'S6': (768, 1365),
}


def process_3dhp_data(data_path: str, subject: str = 'S1',
                      ext_scale: float = 0.001, bbox_res: int = 224,
                      extend_iter: int = 2) -> str:
    """data_path: 3DHP root containing the MPI_SPIN h5 pack, frame images
    under <seq>/imageSequence/, person masks under <seq>/masks/, and
    '<subject>_bkgd.png' plates (reference load_3dhp.py:95-121)."""
    import imageio.v2 as imageio

    if subject in ('S5', 'S6'):
        spin_h5 = os.path.join(data_path, 'mpi_3dhp', '3DHP-S5S6.h5')
        bkgd_path = os.path.join(data_path, 'mpi_3dhp',
                                 f'{subject}_bkgd.png')
    else:
        spin_h5 = os.path.join(data_path, 'MPI_SPIN_rect_output-maxmin.h5')
        bkgd_path = os.path.join(data_path, f'{subject}_bkgd.png')

    spin = read_spin_data(spin_h5, ext_scale=ext_scale,
                          img_res=RES_MAP[subject], bbox_res=bbox_res,
                          subject_filter=subject)
    img_paths = spin.pop('img_path')
    bkgd = imageio.imread(bkgd_path)

    imgs, masks = [], []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else p
        img = imageio.imread(os.path.join(data_path, p))
        mask = imageio.imread(os.path.join(
            data_path, p.replace('/imageSequence/', '/masks/')))
        # released masks use small label values; >=2 means person
        # (load_3dhp.py:122-124)
        mask = (mask >= 2).astype(np.uint8)[..., None]
        imgs.append(img)
        masks.append(mask)

    masks = np.asarray(masks, np.uint8)
    sampling_masks = dilate_masks(masks[..., 0],
                                  iterations=extend_iter)[..., None]
    data = {
        'imgs': np.asarray(imgs, np.uint8),
        'masks': masks,
        'sampling_masks': sampling_masks.astype(np.uint8),
        'kp_idxs': np.arange(len(masks)),
        'cam_idxs': np.arange(len(masks)),
        'bkgds': bkgd[None],
        'bkgd_idxs': np.zeros((len(masks),), np.int64),
        **spin,
    }
    out = os.path.join(data_path, f'{subject}_processed_h5py.h5')
    write_h5(out, data, img_chunk_size=16)
    return out


if __name__ == '__main__':
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('-s', '--subject', type=str, default='S1')
    p.add_argument('-b', '--base_path', type=str, default='data/mpi_3dhp/')
    a = p.parse_args()
    print(process_3dhp_data(a.base_path, a.subject))
