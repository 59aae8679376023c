"""2D/3D skeleton drawing for debug/validation overlays (torch port's copy
of anerf_tpu/utils/skeleton_draw.py; cv2 optional, as there).

Mirrors the reference's cv2-based skeleton drawing
(core/utils/skeleton_utils.py:1363+): project 3D joints with the camera,
draw bone segments colored left/right/center.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.rays import nerf_c2w_to_extrinsic, world_to_cam_np
from ..skeleton import Skeleton, SMPLSkeleton


def _bone_color(name_child: str):
    if 'left' in name_child:
        return (80, 80, 255)
    if 'right' in name_child:
        return (255, 80, 80)
    return (80, 220, 80)


def draw_skeleton_2d(img: np.ndarray, kp2d: np.ndarray,
                     skel: Skeleton = SMPLSkeleton,
                     radius: int = 2) -> np.ndarray:
    """Draw joints + bones onto an HxWx3 uint8 image (in-place copy)."""
    try:
        import cv2
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    out = img.copy()
    H, W = out.shape[:2]
    for j, parent in enumerate(skel.joint_trees):
        if j == skel.root_id:
            continue
        a = kp2d[j]
        b = kp2d[parent]
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            continue
        color = _bone_color(skel.joint_names[j])
        if have_cv2:
            cv2.line(out, tuple(np.round(a).astype(int)),
                     tuple(np.round(b).astype(int)), color, 1)
            cv2.circle(out, tuple(np.round(a).astype(int)), radius, color,
                       -1)
        else:
            # numpy fallback: rasterize the segment coarsely
            n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
            xs = np.linspace(a[0], b[0], n).round().astype(int)
            ys = np.linspace(a[1], b[1], n).round().astype(int)
            ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            out[ys[ok], xs[ok]] = color
    return out


def draw_skeletons_3d(imgs: np.ndarray, kps: np.ndarray, c2ws: np.ndarray,
                      H: int, W: int, focals,
                      centers: Optional[np.ndarray] = None,
                      skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Overlay 3D skeletons onto image stack (N, H, W, 3) uint8."""
    out = []
    for i in range(len(imgs)):
        f = focals if np.isscalar(focals) else focals[i]
        center = None if centers is None else centers[i]
        ext = nerf_c2w_to_extrinsic(np.asarray(c2ws[i]))
        kp2d = world_to_cam_np(np.asarray(kps[i]), ext, H, W, f, center)
        out.append(draw_skeleton_2d(np.asarray(imgs[i]), kp2d, skel))
    return np.stack(out)
