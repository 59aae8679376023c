"""Offline Mixamo raw -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_mixamo.py).

Re-design of reference core/load_mixamo.py:14-106: SPIN estimates + 4-camera
Mixamo renders (images + Masks + per-sequence metadata.pickle with GT poses)
-> canonical h5 with white-composited foregrounds and remapped kp indices.
Requires the raw release on disk; checked on tests/rawlayout.py's
synthetic renders.
"""
from __future__ import annotations

import os
import pickle
from collections import OrderedDict

import numpy as np

from .process_mask import dilate_masks
from .process_spin import read_spin_data
from .schema import write_h5


def process_mixamo_data(data_path: str, subject: str = 'Kachujin',
                        ext_scale: float = 0.001, bbox_res: int = 224,
                        extend_iter: int = 2, n_cam: int = 4) -> str:
    import imageio.v2 as imageio

    spin = read_spin_data(os.path.join(data_path, subject, f'{subject}.h5'),
                          ext_scale=ext_scale, img_res=1000,
                          bbox_res=bbox_res)
    img_paths = spin.pop('img_path')

    imgs, masks, kp_idxs, cam_idxs = [], [], [], []
    seq_dict: 'OrderedDict[str, list]' = OrderedDict()
    for i, p in enumerate(img_paths):
        p = p.decode() if isinstance(p, bytes) else p
        parts = p.split('/')
        d = '/'.join(parts[:3])
        seq_name = parts[1]
        img_name = parts[-1]
        cam_idxs.append(int(parts[2].split('_')[-1]))
        kp_idxs.append(int(img_name[5:-4]) - 1)
        seq_dict.setdefault(seq_name, []).append(i)

        img = imageio.imread(os.path.join(data_path, p))[..., :3]
        mask = imageio.imread(os.path.join(data_path, d, 'Masks',
                                           img_name))[..., :1]
        mask = (mask >= 2).astype(np.uint8)
        imgs.append(img * mask + (1 - mask) * np.full_like(img, 255))
        masks.append(mask)

    # GT poses per sequence (from Camera_0 metadata)
    gt_kps, joint_names = [], None
    for seq in seq_dict:
        meta = pickle.load(open(os.path.join(
            data_path, subject, seq, 'Camera_0', 'metadata.pickle'), 'rb'))
        for pose in meta['gt_pose']:
            entry = pose.item() if hasattr(pose, 'item') else pose
            if joint_names is None:
                joint_names = list(entry.keys())
            gt_kps.append(np.array([entry[j] for j in joint_names]))

    kp_idxs = np.asarray(kp_idxs)
    cam_idxs = np.asarray(cam_idxs)
    # offset per-sequence frame numbers into a global pose index
    offset = 0
    pos = 0
    for seq, members in seq_dict.items():
        seq_len = len(members)
        kp_idxs[pos:pos + seq_len] += offset
        offset += seq_len // n_cam
        pos += seq_len

    masks = np.asarray(masks, np.uint8)
    sampling_masks = dilate_masks(masks[..., 0],
                                  iterations=extend_iter)[..., None]
    data = {
        'img_paths': np.asarray(img_paths),
        'imgs': np.asarray(imgs, np.uint8),
        'masks': masks,
        'sampling_masks': sampling_masks.astype(np.uint8),
        'kp_idxs': kp_idxs,
        'cam_idxs': cam_idxs,
        'gt_poses': np.asarray(gt_kps, np.float32),
        **spin,
    }
    out = os.path.join(data_path, f'{subject}_processed_h5py.h5')
    write_h5(out, data)
    # MixamoDataset trains on a selected-idx subset; the authors ship the
    # curated <subject>_selected.npy separately — emit an all-frames
    # default so a fresh conversion is trainable out of the box
    selected = out.replace('processed_h5py.h5', 'selected.npy')
    if not os.path.exists(selected):
        np.save(selected, np.arange(len(imgs)))
    return out
