"""SURREAL dataset: GT poses, (N_cams, N_kps) grid indexing, white bkgd
(torch port's copy of anerf_tpu/data/surreal.py).

Mirrors reference core/load_surreal.py:302-387 (SurrealDataset). The
offline processing of raw SURREAL dumps, which writes the h5 this class
reads, is data/process_surreal.py.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .dataset import BaseH5Dataset
from .schema import source_path


class SurrealDataset(BaseH5Dataset):
    """Images/cameras arranged as an (N_cams, N_kps) grid: image index
    i -> camera i // N_kps, pose i % N_kps."""

    render_skip = 1
    N_render = 15

    rand_kps = {
        '230': 'data/surreal/surreal_rand_230.npy',
        '400': 'data/surreal/surreal_rand_400.npy',
    }

    def __init__(self, *args, N_rand_kps: Optional[str] = None,
                 N_cams: Optional[int] = None, **kwargs):
        self._N_rand_kps = N_rand_kps
        self._N_kps = int(N_rand_kps.split('_')[-1]) if N_rand_kps else None
        self._N_cams = N_cams
        super().__init__(*args, **kwargs)

    def init_meta(self):
        if self.split == 'val':
            # the val split lives in its own file beside the train file
            self.h5_path = source_path(self.h5_path).replace('train_h5py',
                                                             'val_h5py')
        super().init_meta()

        N_total_cams = len(self.c2ws) // len(self.kp3d)
        N_total_kps = len(self.kp3d)
        if self._N_kps is None:
            self._N_kps = N_total_kps
        if self._N_cams is None:
            self._N_cams = N_total_cams

        if self.split == 'val':
            val_path = 'data/surreal/surreal_val_idxs.npy'
            if os.path.exists(val_path):
                self._idx_map = np.load(val_path)[0::2]
            return
        if self._N_kps == N_total_kps and self._N_cams == N_total_cams:
            return
        if self._N_rand_kps is None:
            selected_kps = np.arange(N_total_kps)
        else:
            selected_kps = np.unique(np.load(self.rand_kps[self._N_rand_kps]))
        selected_cams = np.array([0, 3, 6])[:self._N_cams]
        self._idx_map = np.concatenate(
            [selected_kps + N_total_kps * c for c in selected_cams])

    def get_kp_idx(self, idx, q_idx):
        return idx % len(self.kp3d), q_idx % self._N_kps

    def get_cam_idx(self, idx, q_idx):
        # camera table is pre-expanded to one row per image
        return idx, q_idx // self._N_kps

    def get_meta(self):
        data_attrs = super().get_meta()
        data_attrs['n_views'] = self._N_cams
        return data_attrs

    def get_render_data(self):
        """The base contract, with 'cam_idxs' the camera of each image
        (what get_item gives the train step, and the framecode row), not
        its image index: the framecode table has n_views = N_cams rows.
        The JAX package passes the image index here, which its clamping
        gather maps to the last framecode row past N_cams."""
        render_data = super().get_render_data()
        _, _, _, _, cq_idxs = self._get_subset_idxs(render=True)
        cq_idxs = cq_idxs[::self.render_skip][:self.N_render]
        render_data['cam_idxs'] = np.asarray(cq_idxs).copy()
        render_data['cam_idxs_len'] = self._N_cams
        return render_data
