"""Bounding-cylinder geometry (port of anerf_tpu/ops/cylinder.py):
construction and 2D box projection in numpy (host side, copied), and the
per-ray near/far intersection in torch (device side)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..skeleton import Skeleton, get_skeleton_type


def get_kp_bounding_cylinder(kp: np.ndarray,
                             skel: Skeleton | None = None,
                             ext_scale: float = 0.00035,
                             extend_mm: float = 250,
                             top_expand_ratio: float = 1.0,
                             bot_expand_ratio: float = 0.25,
                             head: str | None = None) -> np.ndarray:
    """Cylinder around keypoints: (..., 5) = (cx, cz, radius, top, bot).
    head: '-y' for SPIN-estimated data, 'z' for SURREAL."""
    if head is None:
        raise ValueError('specify head direction (e.g. "-y" or "z")')
    if head.endswith('z'):
        g_axes, h_axis = [0, 1], 2
    elif head.endswith('y'):
        g_axes, h_axis = [0, 2], 1
    else:
        raise NotImplementedError(f'head orientation {head} not implemented')
    flip = -1 if head.startswith('-') else 1

    if skel is None:
        skel = get_skeleton_type(kp)

    root_loc = kp[..., skel.root_id, :]
    if kp.ndim == 2:
        dist = np.linalg.norm(kp[:, g_axes] - root_loc[g_axes], axis=-1)
    else:
        dist = np.linalg.norm(kp[..., g_axes] - root_loc[..., None, g_axes],
                              axis=-1)
    max_dist = dist.max(-1)
    max_height = (flip * kp[..., h_axis]).max(-1)
    min_height = (flip * kp[..., h_axis]).min(-1)

    extension = extend_mm * ext_scale
    radius = max_dist + extension
    top = flip * (max_height + extension * top_expand_ratio)
    bot = flip * (min_height - extension * bot_expand_ratio)
    return np.stack([root_loc[..., g_axes[0]], root_loc[..., g_axes[1]],
                     radius, top, bot], axis=-1).astype(np.float32)


def get_near_far_in_cylinder(rays_o: torch.Tensor, rays_d: torch.Tensor,
                             cyl: torch.Tensor,
                             near: torch.Tensor | float = 0.35,
                             far: torch.Tensor | float = 2.75,
                             g_axes: Tuple[int, int] = (0, 2),
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray near/far from the 2D circle intersection on the ground plane.

    Rays that miss the circle get the mean near/far of the rays that hit
    (or the input bounds when none hits), as in the JAX version.
    rays_o/rays_d (R, 3), cyl (R, 5), near/far scalar or (R, 1).
    """
    g = list(g_axes)
    R = rays_o.shape[0]
    near_b = torch.as_tensor(near, dtype=rays_o.dtype,
                             device=rays_o.device).reshape(-1, 1).expand(R, 1)
    far_b = torch.as_tensor(far, dtype=rays_o.dtype,
                            device=rays_o.device).reshape(-1, 1).expand(R, 1)

    r_near = (rays_o + rays_d * near_b)[..., g]
    r_far = (rays_o + rays_d * far_b)[..., g]

    radius = cyl[..., 2:3]
    center = cyl[..., :2]

    nc = center - r_near
    nf = r_far - r_near
    nf_norm = torch.linalg.norm(nf, dim=-1)
    scale = torch.linalg.norm(rays_d[..., g], dim=-1, keepdim=True)

    cross = nc[..., 0] * nf[..., 1] - nc[..., 1] * nf[..., 0]
    dist = (torch.abs(cross) / torch.clamp_min(nf_norm, 1e-12))[..., None]

    q2 = radius ** 2 - dist ** 2
    hits = q2 >= 0.0
    Q = torch.sqrt(torch.clamp_min(q2, 0.0))
    K = (torch.sum(nc * nf, dim=-1)
         / torch.clamp_min(nf_norm, 1e-12))[..., None]
    inside = (Q >= K).to(rays_o.dtype)

    new_near = near_b + (1.0 - inside) * (K - Q) / torch.clamp_min(scale,
                                                                    1e-12)
    new_far = near_b + (K + Q) / torch.clamp_min(scale, 1e-12)

    n_valid = torch.clamp_min(hits.sum(), 1)
    mean_near = torch.where(hits, new_near, 0.0).sum() / n_valid
    mean_far = torch.where(hits, new_far, 0.0).sum() / n_valid
    any_valid = hits.any()
    new_near = torch.where(hits, new_near,
                           torch.where(any_valid, mean_near, near_b))
    new_far = torch.where(hits, new_far,
                          torch.where(any_valid, mean_far, far_b))
    return new_near, new_far


def focal_to_intrinsic_np(focal) -> np.ndarray:
    """(3, 4) projection matrix from focal length(s)."""
    if isinstance(focal, (int, float)) or np.asarray(focal).size < 2:
        focal_x = focal_y = float(np.asarray(focal).reshape(-1)[0])
    else:
        focal_x, focal_y = np.asarray(focal).reshape(-1)[:2]
    return np.array([[focal_x, 0, 0, 0],
                     [0, focal_y, 0, 0],
                     [0, 0, 1, 0]], dtype=np.float32)


def cylinder_to_box_2d(cylinder_params: np.ndarray, hwf, w2c=None,
                       scale: float = 1.0, center=None, make_int: bool = True):
    """Project a bounding cylinder to a 2D image-space box: sample 50
    angles on the top/bottom caps, project, take min/max.
    Returns (tl, br, pts_2d)."""
    H, W, focal = hwf
    root_loc, radius = cylinder_params[..., :2], cylinder_params[..., 2:3]
    top, bot = cylinder_params[..., 3:4], cylinder_params[..., 4:5]

    rads = np.linspace(0.0, 2 * np.pi, 50)
    if root_loc.ndim == 1:
        root_loc, radius = root_loc[None], radius[None]
        top, bot = top[None], bot[None]
    N = root_loc.shape[0]

    x = root_loc[..., 0:1] + np.cos(rads)[None] * radius
    z = root_loc[..., 1:2] + np.sin(rads)[None] * radius
    y_top = top * np.ones_like(x)
    y_bot = bot * np.ones_like(x)
    w = np.ones_like(x)

    cap_pts = np.concatenate([
        np.stack([x, y_top, z, w], axis=-1),
        np.stack([x, y_bot, z, w], axis=-1)], axis=-2).reshape(-1, 4)

    intrinsic = focal_to_intrinsic_np(focal)
    if w2c is not None:
        cap_pts = cap_pts @ w2c.T
    cap_pts = (cap_pts @ intrinsic.T).reshape(N, -1, 3)
    pts_2d = cap_pts[..., :2] / cap_pts[..., 2:3]

    max_x = pts_2d[..., 0].max(-1)
    min_x = pts_2d[..., 0].min(-1)
    max_y = pts_2d[..., 1].max(-1)
    min_y = pts_2d[..., 1].min(-1)

    if make_int:
        max_x = np.ceil(max_x).astype(np.int32)
        min_x = np.floor(min_x).astype(np.int32)
        max_y = np.ceil(max_y).astype(np.int32)
        min_y = np.floor(min_y).astype(np.int32)

    tl = np.stack([min_x, min_y], axis=-1)
    br = np.stack([max_x, max_y], axis=-1)

    if center is None:
        offset_x, offset_y = int(W * 0.5), int(H * 0.5)
    else:
        offset_x, offset_y = int(center[0]), int(center[1])
    tl[:, 0] += offset_x
    tl[:, 1] += offset_y
    br[:, 0] += offset_x
    br[:, 1] += offset_y

    if scale != 1.0:
        box_w = (max_x - min_x) * 0.5 * scale
        box_h = (max_y - min_y) * 0.5 * scale
        cx = (br[:, 0] + tl[:, 0]).copy() * 0.5
        cy = (br[:, 1] + tl[:, 1]).copy() * 0.5
        tl[:, 0], br[:, 0] = cx - box_w, cx + box_w
        tl[:, 1], br[:, 1] = cy - box_h, cy + box_h

    tl[:, 0] = np.clip(tl[:, 0], 0, W - 1)
    br[:, 0] = np.clip(br[:, 0], 0, W - 1)
    tl[:, 1] = np.clip(tl[:, 1], 0, H - 1)
    br[:, 1] = np.clip(br[:, 1], 0, H - 1)

    if N == 1:
        tl, br, pts_2d = tl[0], br[0], pts_2d[0]
    return tl, br, pts_2d
