"""MonoPerfCap dataset: tail-n val split + the 1.05 camera scale fix
(torch port's copy of anerf_tpu/data/perfcap.py; numpy only).

Mirrors reference core/load_perfcap.py:54-89.
"""
from __future__ import annotations

import numpy as np

from .dataset import PoseRefinedDataset
from .schema import open_h5


class MonoPerfCapDataset(PoseRefinedDataset):

    n_vals = {'weipeng': 230, 'nadia': 327}
    render_skip = 10
    N_render = 15

    refined_paths = {
        'weipeng': ('data/MonoPerfCap/Weipeng_outdoor/weipeng_refined.tar',
                    True),
        'nadia': ('data/MonoPerfCap/Nadia_outdoor/nadia_refined.tar', True),
    }

    def init_meta(self):
        with open_h5(self.h5_path) as f:
            n_imgs = len(f['imgs'])

        train_idxs = np.arange(n_imgs)
        self._idx_map = None
        if self.split != 'full':
            n_val = self.n_vals[self.subject]
            val_idxs = train_idxs[-n_val:]
            train_idxs = train_idxs[:-n_val]
            if self.split == 'train':
                self._idx_map = train_idxs
            elif self.split == 'val':
                self._idx_map = val_idxs
            else:
                raise NotImplementedError(f'split {self.split}')
        self._n_train = len(train_idxs)
        super().init_meta()
        # MonoPerfCap SPIN estimates are off by a small camera scale
        # (reference load_perfcap.py:89)
        self.c2ws[..., :3, -1] /= 1.05

    def init_temporal_validity(self):
        # temporal smoothness invalid at sequence start; called from the
        # base init_meta (an assignment before super().init_meta() would
        # be overwritten by this hook's return value)
        v = np.ones(self._n_train)
        v[0] = 0
        return v
