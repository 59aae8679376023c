"""Offline MonoPerfCap raw -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_perfcap.py).

Re-design of reference core/load_perfcap.py:12-52: SPIN estimates (from the
authors' MonoPerfCap-<subject> pack) + images/masks/background ->
canonical h5. Requires the raw release on disk; checked on
tests/rawlayout.py's synthetic pack.
"""
from __future__ import annotations

import os

import numpy as np

from .process_mask import dilate_masks
from .process_spin import read_spin_data
from .schema import write_h5


def process_perfcap_data(data_path: str, subject: str = 'Weipeng_outdoor',
                         ext_scale: float = 0.001,
                         img_res=(1080, 1920), bbox_res: int = 224,
                         extend_iter: int = 2) -> str:
    import imageio.v2 as imageio

    spin = read_spin_data(
        os.path.join(data_path, 'MonoPerfCap', f'MonoPerfCap-{subject}.h5'),
        ext_scale=ext_scale, img_res=img_res, bbox_res=bbox_res)
    img_paths = spin.pop('img_path')

    bkgd = imageio.imread(
        os.path.join(data_path, 'MonoPerfCap', subject, 'bkgd.png'))
    imgs, masks = [], []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else p
        img = imageio.imread(os.path.join(data_path, p))
        mask = imageio.imread(
            os.path.join(data_path, p.replace('/images/', '/masks/')))[
                ..., None]
        # the released masks use small label values; >=2 means person
        mask = (mask >= 2).astype(np.uint8)
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
    out = os.path.join(data_path, 'MonoPerfCap', subject,
                       f'{subject}_processed_h5py.h5')
    write_h5(out, data, img_chunk_size=16)
    return out
