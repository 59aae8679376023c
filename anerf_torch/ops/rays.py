"""Camera ray helpers (numpy copies of anerf_tpu/ops/rays.py's host
functions: per-pixel rays and the NeRF <-> CV convention swap)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _focal_xy(focal) -> Tuple[float, float]:
    arr = np.asarray(focal, dtype=np.float32).reshape(-1)
    if arr.size < 2:
        return float(arr[0]), float(arr[0])
    return float(arr[0]), float(arr[1])


def get_rays_np(H: int, W: int, focal, c2w: np.ndarray,
                mesh=None, center=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel rays in world space (NeRF camera convention: -z forward,
    y up in camera frame)."""
    if mesh is None:
        i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32), indexing='xy')
    else:
        i, j = mesh
    focal_x, focal_y = _focal_xy(focal)
    if center is None:
        offset_x, offset_y = W * 0.5, H * 0.5
    else:
        offset_x, offset_y = center
    dirs = np.stack([(i - offset_x) / focal_x,
                     -(j - offset_y) / focal_y,
                     -np.ones_like(i)], -1)
    eye = np.eye(3)
    rot = c2w[:3, :3]
    if np.isclose(eye, rot).all():
        rays_d = dirs
    elif np.isclose(eye, np.abs(rot)).all():
        rays_d = dirs * rot.sum(-1)
    else:
        rays_d = np.sum(dirs[..., np.newaxis, :] * rot, -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def swap_mat(mat: np.ndarray) -> np.ndarray:
    """NeRF <-> CV camera matrix axis swap."""
    return np.concatenate([mat[..., 0:1], -mat[..., 1:2], -mat[..., 2:3],
                           mat[..., 3:]], axis=-1)


def nerf_c2w_to_extrinsic(c2w: np.ndarray) -> np.ndarray:
    """NeRF-convention camera-to-world -> CV extrinsic (world-to-camera)."""
    return np.linalg.inv(swap_mat(c2w))
