"""Camera ray helpers (port of anerf_tpu/ops/rays.py): per-pixel rays
on the host (numpy) and on the device (torch), the (R, 8|11) ray
packing, the NeRF <-> CV convention swap, the projection of world points
to pixels, and the render-time ray culling by the projected bounding
cylinder."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


def get_rays(H: int, W: int, focal, c2w: torch.Tensor, center=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device twin of get_rays_np: (H, W, 3) rays_o and rays_d on the
    device of c2w, in f32."""
    focal_x, focal_y = _focal_xy(focal)
    if center is None:
        offset_x, offset_y = W * 0.5, H * 0.5
    else:
        offset_x, offset_y = center
    dev = c2w.device
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                          torch.arange(H, dtype=torch.float32, device=dev),
                          indexing='xy')
    dirs = torch.stack([(i - offset_x) / focal_x, -(j - offset_y) / focal_y,
                        -torch.ones_like(i)], -1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def swap_mat(mat: np.ndarray) -> np.ndarray:
    """NeRF <-> CV camera matrix axis swap."""
    return np.concatenate([mat[..., 0:1], -mat[..., 1:2], -mat[..., 2:3],
                           mat[..., 3:]], axis=-1)


def nerf_c2w_to_extrinsic(c2w: np.ndarray) -> np.ndarray:
    """NeRF-convention camera-to-world -> CV extrinsic (world-to-camera)."""
    return np.linalg.inv(swap_mat(c2w))


def world_to_cam_np(pts: np.ndarray, extrinsic: np.ndarray, H: int, W: int,
                    focal, center=None) -> np.ndarray:
    """Project world points to pixel coordinates with a CV extrinsic."""
    if center is None:
        offset_x, offset_y = W * 0.5, H * 0.5
    else:
        offset_x, offset_y = center
    focal_x, focal_y = _focal_xy(focal)
    pts_h = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    cam = pts_h @ extrinsic.T
    xy = cam[..., :2] / np.maximum(cam[..., 2:3], 1e-12)
    x = xy[..., 0] * focal_x + offset_x
    y = xy[..., 1] * focal_y + offset_y
    return np.stack([x, y], axis=-1)


def pack_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near, far,
              use_viewdirs: bool = True) -> torch.Tensor:
    """Pack rays into the (R, 8|11) layout [o(3), d(3), near, far,
    viewdir(3)]; near / far are scalars or per-ray values, viewdirs the
    normalized directions."""
    R = rays_o.shape[0]

    def col(v):
        return torch.as_tensor(v, dtype=rays_o.dtype,
                               device=rays_o.device).reshape(-1, 1).expand(
                                   R, 1)
    parts = [rays_o, rays_d, col(near), col(far)]
    if use_viewdirs:
        parts.append(rays_d / torch.linalg.vector_norm(rays_d, dim=-1,
                                                       keepdim=True))
    return torch.cat(parts, -1)


def kp_to_valid_rays_np(poses: np.ndarray, H, W, focal,
                        kps: Optional[np.ndarray] = None,
                        cylinder_params: Optional[np.ndarray] = None,
                        centers=None, ext_scale: float = 0.00035):
    """Render-time ray culling on the host: for each pose, the pixels in
    the 2D box of its projected bounding cylinder. H, W, focal are scalars
    or per-pose. Returns (rays, valid_idxs, cylinder_params, bboxes)."""
    from .cylinder import cylinder_to_box_2d, get_kp_bounding_cylinder

    if cylinder_params is None:
        if kps is None:
            raise ValueError('kp_to_valid_rays_np needs kps or '
                             'cylinder_params')
        cylinder_params = get_kp_bounding_cylinder(
            np.asarray(kps), ext_scale=ext_scale, extend_mm=250,
            top_expand_ratio=1.60, bot_expand_ratio=1.10, head='-y')

    rays, valid_idxs, bboxes = [], [], []
    for i, c2w in enumerate(poses):
        cyl_param = cylinder_params[i % len(cylinder_params)]
        f = focal if isinstance(focal, float) else focal[i]
        center = None if centers is None else centers[i]
        h = H if isinstance(H, int) else H[i]
        w = W if isinstance(W, int) else W[i]

        ray_o, ray_d = get_rays_np(h, w, f, np.asarray(c2w), center=center)
        w2c = nerf_c2w_to_extrinsic(np.asarray(c2w))
        tl, br, _ = cylinder_to_box_2d(cyl_param, [h, w, f], w2c,
                                       center=center)
        hh, ww = np.meshgrid(np.arange(tl[1], br[1]),
                             np.arange(tl[0], br[0]), indexing='ij')
        valid_idx = (hh * w + ww).reshape(-1)
        rays.append((ray_o.reshape(-1, 3)[valid_idx],
                     ray_d.reshape(-1, 3)[valid_idx]))
        valid_idxs.append(valid_idx)
        bboxes.append((tl, br))
    return rays, valid_idxs, cylinder_params, bboxes
