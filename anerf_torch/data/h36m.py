"""Human3.6M dataset: sequence-based splits, multiview kp sharing (torch
port's copy of anerf_tpu/data/h36m.py; numpy only).

Mirrors reference core/load_h36m.py:372-431 (H36MDataset) and the
multi-view mapping (map_data_to_n_views, :306-340).
"""
from __future__ import annotations

import numpy as np

from ..ops.fk import get_smpl_l2ws_np
from .dataset import PoseRefinedDataset
from .schema import open_h5


def _seq_name(p) -> str:
    return (p.decode() if isinstance(p, bytes) else p).split('/')[1]


def find_motion_set(img_paths):
    """Group frames by motion sequence name; paths look like
    S9/Walking-1/imageSequence/<cam>/img_xxxx.jpg."""
    set_dict, set_idxs = {}, []
    set_cnt = 0
    for p in img_paths:
        seq = _seq_name(p)
        if seq not in set_dict:
            set_dict[seq] = set_cnt
            set_cnt += 1
        set_idxs.append(set_dict[seq])
    return set_dict, set_cnt, np.array(set_idxs)


def create_kp_mapping(set_dict, set_cnt, set_idxs, n_views: int = 4):
    """kp_map: frame -> shared pose row; kp_uidxs: one representative frame
    per shared pose."""
    kp_map = np.zeros(len(set_idxs), dtype=np.int64)
    kp_uidxs = []
    offset = 0
    for s in range(set_cnt):
        frame_idxs = np.where(set_idxs == s)[0]
        n_per_view = len(frame_idxs) // n_views
        for k, fi in enumerate(frame_idxs):
            kp_map[fi] = offset + (k % n_per_view)
        kp_uidxs.extend(frame_idxs[:n_per_view].tolist())
        offset += n_per_view
    return kp_map, np.array(kp_uidxs)


def map_data_to_n_views(img_paths, kp3d, bones, rest_pose, n_views: int = 4,
                        avg_kps: bool = True):
    """Share non-root pose across views; per-view roots stay
    (reference load_h36m.py:306-340)."""
    def set_root(k, k_unique, k_map, root_id=0):
        root = k[:, root_id:root_id + 1]
        if not avg_kps:
            other = k_unique[k_map, root_id + 1:]
        else:
            other = np.zeros_like(k_unique[:, root_id + 1:])
            for i, k_idx in enumerate(k_map):
                other[k_idx] = other[k_idx] + k[i, root_id + 1:]
            other = (other / float(n_views))[k_map]
        return np.concatenate([root, other], axis=1)

    set_dict, set_cnt, set_idxs = find_motion_set(img_paths)
    kp_map, kp_uidxs = create_kp_mapping(set_dict, set_cnt, set_idxs, n_views)

    unique_bones = bones[kp_uidxs]
    unique_kp3d = kp3d[kp_uidxs]
    bones = set_root(bones, unique_bones, kp_map)
    kp3d = set_root(kp3d, unique_kp3d, kp_map)

    l2ws = np.array([get_smpl_l2ws_np(b, rest_pose) for b in bones])
    l2ws[..., :3, -1] = l2ws[..., :3, -1] + kp3d[:, 0:1].copy()
    skts = np.array([np.linalg.inv(l2w) for l2w in l2ws])
    return kp_map, kp_uidxs, kp3d, bones, skts


class H36MDataset(PoseRefinedDataset):

    render_skip = 80
    N_render = 15

    refined_paths = {
        'S9': ('data/h36m/S9_refined_64.tar', True),
        'S11': ('data/h36m/S11_refined_64.tar', True),
    }

    val_sets = ('Greeting-', 'Walking-', 'Posing-')

    def init_meta(self):
        with open_h5(self.h5_path) as f:
            img_paths = f['img_paths'][:]

        self._idx_map = None
        if self.subject and self.subject.endswith('c'):
            idxs = [i for i, p in enumerate(img_paths)
                    if _seq_name(p).endswith('-1')]
            self._idx_map = np.array(idxs)
        elif self.split != 'full':
            train_idxs, val_idxs = [], []
            for i, p in enumerate(img_paths):
                seq = _seq_name(p)
                if any(seq.startswith(v) for v in self.val_sets):
                    val_idxs.append(i)
                else:
                    train_idxs.append(i)
            if self.split == 'train':
                self._idx_map = np.array(train_idxs)
            elif self.split == 'val':
                self._idx_map = np.array(val_idxs)
            else:
                raise NotImplementedError(f'split {self.split} undefined')
        super().init_meta()

    def _load_multiview_pose(self, f, kp3d, bones, skts, cyls):
        rest_pose = f['rest_pose'][:]
        img_paths = f['img_paths'][:]
        kp_map, kp_uidxs, kp3d, bones, skts = map_data_to_n_views(
            img_paths, kp3d, bones, rest_pose)
        self.kp_map = kp_map
        self.kp_uidxs = kp_uidxs
        return kp3d, bones, skts, cyls
