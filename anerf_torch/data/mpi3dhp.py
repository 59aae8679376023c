"""MPI-INF-3DHP dataset: ::9 val split + per-subject fixes (torch port's
copy of anerf_tpu/data/mpi3dhp.py; numpy only).

Mirrors reference core/load_3dhp.py (partial/legacy in the reference:
`load_3dhp_data` targets the pre-h5 loader format and the dataset is
absent from its DATASET_CATALOG), on the canonical h5 schema so 3DHP rides
the same BaseH5Dataset pipeline as every other dataset here. Per-subject
quirks carried over from load_3dhp.py:145-160: S2 backgrounds zeroed
(background tone too close to the subject), S5/S6 camera translations
divided by 0.82.
"""
from __future__ import annotations

import numpy as np

from .dataset import BaseH5Dataset
from .schema import open_h5


class ThreeDHPDataset(BaseH5Dataset):

    render_skip = 9
    N_render = 15

    def init_meta(self):
        with open_h5(self.h5_path) as f:
            n_imgs = len(f['imgs'])

        all_idxs = np.arange(n_imgs)
        val_idxs = all_idxs[::9]          # load_3dhp.py:192
        self._idx_map = None
        if self.split == 'train':
            self._idx_map = all_idxs
        elif self.split == 'val':
            self._idx_map = val_idxs
        elif self.split != 'full':
            raise NotImplementedError(f'split {self.split}')

        self._n_imgs = n_imgs
        super().init_meta()

        if self.subject == 'S2':
            # background tone too close to the subject (load_3dhp.py:153)
            self.bgs = np.zeros_like(self.bgs)
        if self.subject in ('S5', 'S6'):
            self.c2ws = self.c2ws.copy()
            self.c2ws[..., :3, -1] /= 0.82  # load_3dhp.py:155-159

    def init_temporal_validity(self):
        # temporal smoothness invalid at sequence start (load_3dhp.py:150)
        v = np.ones(self._n_imgs)
        v[0] = 0
        return v
