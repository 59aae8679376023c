"""Offline Human3.6M raw -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_h36m.py).

Re-design of reference core/load_h36m.py:114-243: SPIN estimates + DeepLab
mask pack + per-camera clean/chair backgrounds -> canonical h5. Requires
the authors' preprocessed packs on disk (SPIN .h5, mask .h5, bkgd .npy);
checked on tests/rawlayout.py's synthetic packs. HDF5 packs are read through h5py (see
process_spin._load_spin_file) instead of deepdish.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .process_mask import dilate_masks
from .process_spin import _load_spin_file, read_spin_data
from .schema import write_h5

H36M_CAMERAS = ('54138969', '55011271', '58860488', '60457274')
CHAIR_SEQS = ('Sitting-', 'Eating-', 'Phoning-', 'Smoking-')


def process_h36m_data(data_path: str, subject: str = 'S9',
                      ext_scale: float = 0.001, res: float = 1.0,
                      bbox_res: int = 224, extend_iter: int = 2,
                      camera_name: Optional[str] = None) -> str:
    import imageio.v2 as imageio

    if camera_name is None:
        spin_pack = os.path.join(data_path,
                                 f'{subject}_SPIN_rect_output-maxmin.h5')
        mask_pack = os.path.join(data_path,
                                 f'{subject}_mask_deeplab_crop.h5')
    else:
        sub = 1 if subject == 'S1' else 5
        spin_pack = os.path.join(
            data_path, f'{subject}-camera=[{camera_name}]-subsample={sub}.h5')
        mask_pack = os.path.join(
            data_path, f'{subject}_{camera_name}_mask_deeplab_crop.h5')

    bkgds = np.load(os.path.join(
        data_path, f"{subject.replace('s', '')}_clean_bkgds.npy"))
    chair_bkgds = np.load(os.path.join(
        data_path, f"{subject.replace('s', '')}_chair_bkgds.npy"))
    bkgds = np.concatenate([bkgds, chair_bkgds], axis=0)

    mask_data = _load_spin_file(mask_pack)
    masks = np.asarray(mask_data['masks']).astype(np.uint8)
    if masks.ndim <= 3:
        masks = masks[..., None]
    if masks.max() > 1:
        masks = (masks >= 2).astype(np.uint8)
    H = W = masks.shape[-2]
    res = float(mask_data.get('res', res))

    spin = read_spin_data(spin_pack, ext_scale, img_res=H, bbox_res=bbox_res)
    if res != 1.0:
        spin['focals'] = spin['focals'] * res
        new_W, new_H = int(res * W), int(res * H)
        import cv2
        bkgds = np.stack([cv2.resize(b, (new_W, new_H),
                                     interpolation=cv2.INTER_AREA)
                          for b in bkgds])

    sampling_masks = dilate_masks(masks[..., 0],
                                  iterations=extend_iter)[..., None]

    cameras = H36M_CAMERAS if subject != 'S1' else (H36M_CAMERAS[-1],)
    img_paths = spin.pop('img_path')
    imgs, cam_idxs = [], []
    for p in img_paths:
        p = p.decode() if isinstance(p, bytes) else p
        # chair sequences use the second background block
        offset = len(cameras) if any(cs in p for cs in CHAIR_SEQS) else 0
        cam_idx = next((e for e, c in enumerate(cameras) if c in p), 0)
        cam_idxs.append(cam_idx + offset)

        img = imageio.imread(os.path.join(data_path, p))
        if img.shape[0] != H:
            # one camera is 1002x1000; crop to square
            img = img[1:-1]
        if res != 1.0:
            import cv2
            img = cv2.resize(img, (int(res * W), int(res * H)),
                             interpolation=cv2.INTER_AREA)
        imgs.append(img)

    data = {
        'imgs': np.asarray(imgs, np.uint8),
        'masks': masks,
        'sampling_masks': sampling_masks.astype(np.uint8),
        'bkgds': bkgds.astype(np.uint8),
        'bkgd_idxs': np.asarray(cam_idxs, np.int64),
        'img_paths': np.asarray(img_paths),
        **spin,
    }
    suffix = '' if camera_name is None else f'_{camera_name}'
    out = os.path.join(data_path, f'{subject}{suffix}_processed_h5py.h5')
    write_h5(out, data)
    return out
