"""Render catalog: per-dataset/subject selected frames + mode parameters
(torch port's copy of anerf_tpu/render/catalog.py).

Mirrors the reference's hard-coded RenderCatalog: the same selected
indices and per-mode defaults, organized as plain dicts. Entries
reference h5 files under data/ (paths relative to the working directory)
and, optionally, refined pose checkpoints.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _load_idxs(path):
    if not os.path.exists(path):
        return []
    return np.load(path)


def _set(selected_idxs, **kwargs) -> Dict[str, Any]:
    return {'selected_idxs': np.array(selected_idxs), **kwargs}


def init_catalog(n_bullet: int = 10) -> Dict[str, Dict[str, Any]]:
    s9_idx = [121, 500, 1000, 1059, 1300, 1600, 1815, 2400, 3014, 3702, 4980]
    h36m_s9 = {
        'data_h5': 'data/h36m/S9_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/h36m/s9_sub64_500k.tar',
        'retarget': _set(s9_idx, length=5),
        'bullet': _set([0], n_bullet=n_bullet, undo_rot=False,
                       center_cam=True),
        'interpolate': _set(s9_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'correction': _set(_load_idxs('data/h36m/S9_top50_refined.npy')[:1],
                           n_step=30),
        'animate': _set([1000, 1059, 2400], n_step=10, center_cam=True,
                        center_kps=True, joints=[17, 19, 21, 23]),
        'bubble': _set(s9_idx, n_step=30),
        'poserot': _set([1000]),
        'val': _set(_load_idxs('data/h36m/S9_val_idxs.npy'), length=1,
                    skip=1),
    }
    s11_idx = [213, 656, 904, 1559, 1815, 2200, 2611, 2700, 3110, 3440, 3605]
    h36m_s11 = {
        'data_h5': 'data/h36m/S11_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/h36m/s11_sub64_500k.tar',
        'retarget': _set(s11_idx, length=5),
        'bullet': _set(s11_idx, n_bullet=n_bullet),
        'interpolate': _set(s11_idx, n_step=10, undo_rot=True,
                            center_cam=True),
        'bubble': _set(s11_idx, n_step=30),
        'val': _set(_load_idxs('data/h36m/S11_val_idxs.npy'), length=1,
                    skip=1),
    }
    surreal_idx = [0, 8, 16, 24, 32, 40, 48, 56]
    surreal = {
        'data_h5': 'data/surreal/surreal_train_h5py.h5',
        'val_h5': 'data/surreal/surreal_val_h5py.h5',
        'retarget': _set(surreal_idx, length=1, skip=1, is_surreal=True),
        'bullet': _set(surreal_idx, n_bullet=n_bullet, center_cam=True,
                       center_kps=True),
        'interpolate': _set(surreal_idx, n_step=10, center_cam=True),
        'animate': _set(surreal_idx[:3], n_step=10, center_cam=True,
                        center_kps=True, joints=[18, 19, 20, 21]),
        'bubble': _set(surreal_idx, n_step=30),
        'poserot': _set([0]),
        'mesh': _set([0]),
        'val': _set([], length=1, skip=1),
    }
    perfcap_weipeng = {
        'data_h5': 'data/MonoPerfCap/Weipeng_outdoor/'
                   'Weipeng_outdoor_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/perfcap/weipeng_tv_500k.tar',
        'retarget': _set([0, 50, 100], length=30, skip=2),
        'bullet': _set([180, 270, 870], n_bullet=n_bullet),
        'interpolate': _set([420, 470], n_step=10, center_cam=True),
        'bubble': _set([180, 270, 870], n_step=30),
        'val': _set(np.arange(1151)[-230:], length=1, skip=1),
    }
    perfcap_nadia = {
        'data_h5': 'data/MonoPerfCap/Nadia_outdoor/'
                   'Nadia_outdoor_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/perfcap/nadia_tv_500k.tar',
        'retarget': _set([0, 100, 300], length=30, skip=2),
        'bullet': _set([300, 480, 700], n_bullet=n_bullet),
        'interpolate': _set([460, 520], n_step=10, center_cam=True),
        'bubble': _set([300, 480, 700], n_step=30),
        'val': _set(np.arange(1635)[-327:], length=1, skip=1),
    }
    mixamo_james = {
        'data_h5': 'data/mixamo/James_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/mixamo/james_500k.tar',
        'retarget': _set([0, 1000, 2000], length=30, skip=2),
        'bullet': _set([0, 1000, 2000], n_bullet=n_bullet),
        'interpolate': _set([0, 1000], n_step=10, center_cam=True),
        'bubble': _set([0, 1000, 2000], n_step=30),
        'mesh': _set([0]),
        'val': _set([], length=1, skip=1),
    }
    mixamo_archer = {
        'data_h5': 'data/mixamo/Archer_processed_h5py.h5',
        'refined': 'neurips21_ckpt/trained/ours/mixamo/archer_500k.tar',
        'retarget': _set([0, 1000, 2000], length=30, skip=2),
        'bullet': _set([0, 1000, 2000], n_bullet=n_bullet),
        'interpolate': _set([0, 1000], n_step=10, center_cam=True),
        'bubble': _set([0, 1000, 2000], n_step=30),
        'val': _set([], length=1, skip=1),
    }
    return {
        'h36m': {'S9': h36m_s9, 'S11': h36m_s11},
        'surreal': {'female': surreal},
        'perfcap': {'weipeng': perfcap_weipeng, 'nadia': perfcap_nadia},
        'mixamo': {'james': mixamo_james, 'archer': mixamo_archer},
    }
