"""ZJU-MoCap / NeuralBody dataset: multi-camera with explicit kp/cam index
tables, per-image centers and dual focals (torch port's copy of
anerf_tpu/data/zju.py; numpy only).

Mirrors reference core/load_zju.py:536-640. The test split is the file
beside the train file with 'train' replaced by 'test' in its path (for
in-memory arrays, in their H5Arrays.path), opened from disk.
"""
from __future__ import annotations

import numpy as np

from .dataset import BaseH5Dataset
from .schema import open_h5, source_path


class ZJUMocapDataset(BaseH5Dataset):

    N_render = 15
    render_skip = 63

    def init_meta(self):
        if self.split == 'test':
            self.h5_path = source_path(self.h5_path).replace('train', 'test')
        super().init_meta()
        with open_h5(self.h5_path) as f:
            self.kp_idxs_table = f['kp_idxs'][:]
            self.cam_idxs_table = f['img_pose_indices'][:]
        if self.split == 'test':
            n_unique_cam = len(np.unique(self.cam_idxs_table))
            self.kp_idxs_table = self.kp_idxs_table // n_unique_cam

    def get_kp_idx(self, idx, q_idx):
        return self.kp_idxs_table[idx], q_idx

    def get_cam_idx(self, idx, q_idx):
        return self.cam_idxs_table[idx], q_idx

    def _get_subset_idxs(self, render=False):
        if self._idx_map is not None:
            i_idxs = self._idx_map
            _k = _c = self._idx_map
            _kq = _cq = np.arange(len(self._idx_map))
        else:
            i_idxs = np.arange(self._N_total_img)
            _k = _kq = np.arange(self._N_total_img)
            _c = _cq = np.arange(self._N_total_img)
        k_idxs, kq_idxs = self.get_kp_idx(_k, _kq)
        c_idxs, cq_idxs = self.get_cam_idx(_c, _cq)
        return k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs

    def get_render_data(self):
        """The base contract, with 'cam_idxs' each image's framecode row
        (its place in the split: what get_item gives the train step; the
        table has n_views = data_len rows), not its camera. The JAX
        package gives the camera here, so its validation render reads
        the framecodes of the first images instead of the rendered
        ones'. The cameras still pick 'c2ws', 'hwf' and 'center'."""
        render_data = super().get_render_data()
        _, _, _, _, cq_idxs = self._get_subset_idxs(render=True)
        cq_idxs = cq_idxs[::self.render_skip][:self.N_render]
        render_data['cam_idxs'] = np.asarray(cq_idxs).copy()
        render_data['cam_idxs_len'] = self.data_len
        return render_data


class ZJUH36MDataset(ZJUMocapDataset):

    N_render = 30
    render_skip = 1

    def init_meta(self):
        super().init_meta()
        idxs = np.arange(len(self.kp_idxs_table))
        train_idxs, val_idxs = idxs[:-30], idxs[-30:]
        if self.split == 'train':
            self._idx_map = train_idxs
        elif self.split == 'val':
            self._idx_map = val_idxs
        self.init_len()
