"""Render-mode pose/camera builders (numpy copies of the bullet-time and
selected-frame builders in anerf_tpu/render/modes.py). Every builder is a
pure numpy function over a PoseSource; all return {'kp3d', 'skts',
'bones', 'c2ws', 'cam_idxs', 'focals'}."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from ..ops.fk import get_smpl_l2ws_np


def rotate_x(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_z(psi):
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def generate_bullet_time(c2w: np.ndarray, n_views: int = 20,
                         axis: str = 'y') -> np.ndarray:
    """Rotate camera(s) around the world axis."""
    rotate_fn = {'x': rotate_x, 'y': rotate_y, 'z': rotate_z}[axis]
    angles = np.linspace(0, math.radians(360), n_views + 1)[:-1]
    return np.array([rotate_fn(a) @ c2w for a in angles])


@dataclasses.dataclass
class PoseSource:
    """Pose + camera data a render mode draws from."""
    kps: np.ndarray          # (N, J, 3)
    bones: np.ndarray        # (N, J, 3) axis-angle
    c2ws: np.ndarray         # (N, 4, 4)
    focals: np.ndarray       # (N,) or scalar
    rest_pose: np.ndarray    # (J, 3)

    def focals_at(self, idxs) -> np.ndarray:
        if np.isscalar(self.focals):
            return np.full((len(idxs),), float(self.focals), np.float32)
        return np.asarray(self.focals)[idxs]


def _fk_many(bones: np.ndarray, rest_pose: np.ndarray, roots: np.ndarray):
    """FK over a batch, roots (N, 1, 3) world pelvis positions."""
    l2ws = np.array([get_smpl_l2ws_np(b, rest_pose) for b in bones])
    l2ws[..., :3, -1] += roots
    kps = l2ws[..., :3, -1]
    skts = np.linalg.inv(l2ws)
    return kps.astype(np.float32), skts.astype(np.float32)


UNDO_ROT = np.array([1.5708, 0., 0.], dtype=np.float32)


def load_selected(src: PoseSource, selected_idxs: np.ndarray,
                  idx_map=None) -> Dict[str, np.ndarray]:
    """Render the selected frames from their own cameras."""
    sel = np.asarray(selected_idxs)
    c2ws = src.c2ws[sel]
    focals = src.focals_at(sel)
    kps, bones = src.kps[sel].copy(), src.bones[sel].copy()
    cam_idxs = sel if idx_map is None else np.asarray(idx_map)[sel]
    kps, skts = _fk_many(bones, src.rest_pose, kps[..., :1, :].copy())
    return {'kp3d': kps, 'skts': skts, 'bones': bones, 'c2ws': c2ws,
            'cam_idxs': cam_idxs, 'focals': focals}


def load_bullettime(src: PoseSource, selected_idxs: np.ndarray,
                    n_bullet: int = 30, undo_rot: bool = False,
                    center_cam: bool = True, center_kps: bool = True,
                    idx_map=None) -> Dict[str, np.ndarray]:
    """360-degree camera orbit per selected pose."""
    sel = np.asarray(selected_idxs)
    c2ws = src.c2ws[sel].copy()
    shift_x = c2ws[..., 0, -1].copy()
    shift_y = c2ws[..., 1, -1].copy()
    if center_cam:
        c2ws[..., :2, -1] = 0.
    c2ws = generate_bullet_time(c2ws, n_bullet).transpose(
        1, 0, 2, 3).reshape(-1, 4, 4)

    focals = src.focals_at(sel)[:, None].repeat(n_bullet, 1).reshape(-1)
    kps, bones = src.kps[sel].copy(), src.bones[sel].copy()
    cam_idxs = (sel if idx_map is None else np.asarray(idx_map)[sel])
    cam_idxs = cam_idxs[:, None].repeat(n_bullet, 1).reshape(-1)

    if center_kps:
        kps = kps - kps[..., :1, :]
    elif center_cam:
        kps[..., :, 0] -= shift_x[:, None]
        kps[..., :, 1] -= shift_y[:, None]
    if undo_rot:
        bones[..., 0, :] = UNDO_ROT

    kps, skts = _fk_many(bones, src.rest_pose, kps[..., :1, :].copy())
    n_sel = len(sel)
    kps = kps[:, None].repeat(n_bullet, 1).reshape(n_sel * n_bullet, -1, 3)
    skts = skts[:, None].repeat(n_bullet, 1).reshape(n_sel * n_bullet, -1,
                                                     4, 4)
    bones_rep = bones[:, None].repeat(n_bullet, 1).reshape(
        n_sel * n_bullet, -1, 3)
    return {'kp3d': kps, 'skts': skts, 'bones': bones_rep, 'c2ws': c2ws,
            'cam_idxs': cam_idxs, 'focals': focals}
