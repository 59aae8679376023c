"""Mixamo dataset: selected-idx subsets, white bkgd, temporal validity
(torch port's copy of anerf_tpu/data/mixamo.py; numpy only).

Mirrors reference core/load_mixamo.py:137-199. The selected subset is
`selected.npy` beside the h5 (for in-memory arrays, beside their
H5Arrays.path).
"""
from __future__ import annotations

import os

import numpy as np

from .dataset import PoseRefinedDataset
from .schema import open_h5, source_path


def get_temporal_validity(img_paths):
    """A frame is temporally valid when the previous frame is the
    consecutive image of the same sequence (load_mixamo.py:137-159)."""
    valid = np.ones((len(img_paths),))
    seq_map = np.zeros((len(img_paths),), dtype=np.int32)
    seq_cnt = 0

    def parts(p):
        p = p.decode() if isinstance(p, bytes) else p
        base = os.path.splitext(os.path.basename(p))[0]
        num = int(base.split('Image')[-1])
        return os.path.dirname(p), num

    for i in range(len(img_paths)):
        if i == 0:
            valid[i] = 0
            continue
        prev_dir, prev_num = parts(img_paths[i - 1])
        cur_dir, cur_num = parts(img_paths[i])
        if prev_dir != cur_dir or abs(cur_num - prev_num) > 1:
            valid[i] = 0
            seq_cnt += 1
        seq_map[i] = seq_cnt
    return valid, seq_map


def selected_path(h5_path: str) -> str:
    """The selected-subset file beside a Mixamo h5."""
    return h5_path.replace('processed_h5py.h5', 'selected.npy')


class MixamoDataset(PoseRefinedDataset):

    render_skip = 40
    N_render = 15
    refined_paths = {
        'james': ('data/mixamo/james_refined.tar', True),
        'archer': ('data/mixamo/archer_refined.tar', True),
    }

    def _load_pose_data(self, f):
        kp3d, bones = f['kp3d'][:], f['bones'][:]
        skts, cyls = f['skts'][:], f['cyls'][:]
        if not self.load_refined:
            return kp3d, bones, skts, cyls
        # refinement covers only the selected subset
        r_kp3d, r_bones, r_skts, r_cyls = super()._load_pose_data(f)
        kp3d[self._idx_map] = r_kp3d
        bones[self._idx_map] = r_bones
        skts[self._idx_map] = r_skts
        cyls[self._idx_map] = r_cyls
        return kp3d, bones, skts, cyls

    def init_meta(self):
        selected = selected_path(source_path(self.h5_path))
        self._idx_map = np.array(sorted(np.load(selected)))
        super().init_meta()
        with open_h5(self.h5_path) as f:
            n_imgs = f['imgs'].shape[0]
            img_paths = f['img_paths'][self._idx_map]
        # white background
        self.bgs = np.ones((1, int(np.prod(self.HW)), 3), np.uint8) * 255
        self.bg_idxs = np.zeros((n_imgs,), np.int64)
        self.has_bg = True
        self.temp_validity = get_temporal_validity(img_paths)[0]
