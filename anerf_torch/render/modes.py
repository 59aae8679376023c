"""Render-mode pose/camera builders: bullet-time, interpolation, animation,
retargeting, bubble, pose-rotation, correction, selected (numpy copies of
anerf_tpu/render/modes.py; the root-rotation conversions of
load_pose_rotate go through the port's torch ops/rotations on the CPU).

Every builder is a pure numpy function over a PoseSource (kps, bones,
c2ws, focals, rest_pose); all return {'kp3d', 'skts', 'bones', 'c2ws',
'cam_idxs', 'focals'}. 'cam_idxs' are IMAGE indices, as in the JAX
package: the caller maps them to framecode rows (run_render.py)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

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


def translate(tx, ty, tz):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (tx, ty, tz)
    return m


def generate_camera_path(amp_wobble: float = 15.0, amp_dist: float = 0.5,
                         dist: float = 3.0,
                         center=np.array([0., 0., 0.]),
                         n_cams: int = 60) -> np.ndarray:
    """SURREAL-style orbit: a zoom-in/out ring followed by a wobble ring
    (the reference's SURREAL loader). Returns (2*n_cams, 4, 4) c2ws."""
    angles = np.linspace(0, math.radians(360), n_cams + 1)[:-1]
    wave = np.sin(np.linspace(0, math.radians(360 * 4), n_cams + 1)[:-1])

    loc = np.array([dist, 0., 0.], np.float32)
    forward = np.array([1., 0., 0.], np.float32)
    right = np.array([0., 0., -1.], np.float32)
    up = np.cross(forward, right)
    cam = np.concatenate(
        [np.stack([right, up, forward, loc], axis=1),
         np.array([[0., 0., 0., 1.]], np.float32)], axis=0)

    poses = []
    center_t = translate(*np.asarray(center, np.float32))
    for a, d in zip(angles, amp_dist * wave):
        poses.append(center_t @ rotate_y(a) @ translate(d, 0., 0.) @ cam)
    wobble = math.radians(amp_wobble) * wave + math.radians(30)
    for a, w in zip(angles, wobble):
        poses.append(rotate_y(a) @ rotate_z(w) @ cam)
    return np.array(poses, np.float32)


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


def load_interpolate(src: PoseSource, selected_idxs: np.ndarray,
                     n_step: int = 10, undo_rot: bool = False,
                     center_cam: bool = False, center_kps: bool = False,
                     idx_map=None, joints: Optional[Sequence[int]] = None
                     ) -> Dict[str, np.ndarray]:
    """Linear bone interpolation between consecutive selected poses, fixed
    camera. With `joints`, only those joints animate (load_animate)."""
    sel = np.asarray(selected_idxs)
    c2ws = src.c2ws[sel].copy()
    shift_x = c2ws[..., 0, -1].copy()
    shift_y = c2ws[..., 1, -1].copy()
    if center_cam:
        c2ws[..., :2, -1] = 0.
    focals = src.focals_at(sel)
    kps, bones = src.kps[sel].copy(), src.bones[sel].copy()
    cam_idxs = sel if idx_map is None else np.asarray(idx_map)[sel]

    if center_kps:
        kps = kps - kps[..., :1, :]
    elif center_cam:
        kps[..., :, 0] -= shift_x[:, None]
        kps[..., :, 1] -= shift_y[:, None]
    if undo_rot:
        bones[..., 0, :] = UNDO_ROT

    j = np.asarray(joints) if joints is not None else \
        np.arange(bones.shape[1])
    w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
    interp = []
    for i in range(len(bones) - 1):
        a, b = bones[i:i + 1, j], bones[i + 1:i + 2, j]
        interp.append(a * (1 - w) + b * w)
    interp.append(bones[-1:, j])
    interp = np.concatenate(interp, axis=0)
    out_bones = bones[:1].repeat(len(interp), 0).copy()
    out_bones[:, j] = interp

    kps_out, skts = _fk_many(out_bones, src.rest_pose,
                             kps[:1, :1, :].copy())
    n = len(kps_out)
    return {'kp3d': kps_out, 'skts': skts, 'bones': out_bones,
            'c2ws': c2ws[:1].repeat(n, 0),
            'cam_idxs': np.asarray(cam_idxs)[:1].repeat(n, 0),
            'focals': focals[:1].repeat(n, 0)}


def load_animate(src: PoseSource, selected_idxs, joints, n_step: int = 10,
                 **kwargs) -> Dict[str, np.ndarray]:
    """Animate a subset of joints between poses."""
    return load_interpolate(src, selected_idxs, n_step=n_step, joints=joints,
                            **kwargs)


def load_retarget(src: PoseSource, pose_src: PoseSource,
                  selected_idxs: np.ndarray, length: int, skip: int = 1,
                  center_kps: bool = False, undo_rot: bool = False,
                  idx_map=None) -> Dict[str, np.ndarray]:
    """Drive the learned character with poses from another source."""
    sel = np.asarray(selected_idxs)
    if skip > 1 and length > 1:
        sel = np.concatenate(
            [np.arange(s, min(s + length, len(pose_src.c2ws)))[::skip]
             for s in sel])
    c2ws = src.c2ws[sel % len(src.c2ws)]
    focals = src.focals_at(sel % len(src.c2ws))
    cam_idxs = sel if idx_map is None else np.asarray(idx_map)[sel]

    kps = pose_src.kps[sel % len(pose_src.kps)].copy()
    bones = pose_src.bones[sel % len(pose_src.bones)].copy()
    if center_kps:
        kps = kps - kps[..., :1, :]
    if undo_rot:
        bones[..., 0, :] = UNDO_ROT
    kps, skts = _fk_many(bones, src.rest_pose, kps[..., :1, :].copy())
    return {'kp3d': kps, 'skts': skts, 'bones': bones, 'c2ws': c2ws,
            'cam_idxs': cam_idxs, 'focals': focals}


def load_pose_rotate(src: PoseSource, selected_idxs: np.ndarray,
                     n_bullet: int = 30, idx_map=None
                     ) -> Dict[str, np.ndarray]:
    """Rotate the root bone around y/x/z with a fixed camera."""
    import torch

    from ..ops.rotations import axisang_to_rot, rot_to_axisang

    sel = np.asarray(selected_idxs)
    kps, bones = src.kps[sel].copy(), src.bones[sel].copy()

    rot0 = np.eye(4, dtype=np.float32)
    rot0[:3, :3] = axisang_to_rot(
        torch.as_tensor(bones[0, 0], dtype=torch.float32)).numpy()
    rots = np.concatenate([
        generate_bullet_time(rot0, n_bullet // 3, axis)
        for axis in ('y', 'x', 'z')], axis=0)
    root_rotated = rot_to_axisang(
        torch.as_tensor(rots[:, :3, :3], dtype=torch.float32)).numpy()

    n = len(root_rotated)
    bones = bones.repeat(n, 0)
    bones[..., 0, :] = root_rotated
    c2ws = src.c2ws[sel].repeat(n, 0)
    focals = src.focals_at(sel).repeat(n, 0)
    cam_idxs = (sel if idx_map is None else np.asarray(idx_map)[sel]
                ).repeat(n, 0)
    kps, skts = _fk_many(bones, src.rest_pose,
                         src.kps[sel][..., :1, :].repeat(n, 0).copy())
    return {'kp3d': kps, 'skts': skts, 'bones': bones, 'c2ws': c2ws,
            'cam_idxs': cam_idxs, 'focals': focals}


def load_correction(src: PoseSource, refined: PoseSource,
                    selected_idxs: np.ndarray, n_step: int = 8,
                    idx_map=None) -> Dict[str, np.ndarray]:
    """Morph from initial (SPIN) poses to refined poses."""
    sel = np.asarray(selected_idxs)
    c2ws = src.c2ws[sel]
    focals = src.focals_at(sel)
    init_bones = src.bones[sel]
    refined_kps = refined.kps[sel]
    refined_bones = refined.bones[sel]

    w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
    interp = np.concatenate([
        ib[None] * (1 - w) + rb[None] * w
        for ib, rb in zip(init_bones, refined_bones)], axis=0)
    roots = refined_kps[:, None, :1, :].repeat(n_step, 1).reshape(-1, 1, 3)
    kps, skts = _fk_many(interp, src.rest_pose, roots)
    return {'kp3d': kps, 'skts': skts, 'bones': interp,
            'c2ws': c2ws[:, None].repeat(n_step, 1).reshape(-1, 4, 4),
            'cam_idxs': sel[:, None].repeat(n_step, 1).reshape(-1),
            'focals': focals[:, None].repeat(n_step, 1).reshape(-1)}


def load_bubble(src: PoseSource, selected_idxs: np.ndarray,
                x_deg: float = 15., y_deg: float = 25., z_t: float = 0.1,
                n_step: int = 5, idx_map=None) -> Dict[str, np.ndarray]:
    """Small circular camera 'bubble' motion around each pose."""
    sel = np.asarray(selected_idxs)
    x_rad = x_deg * np.pi / 180.
    y_rad = y_deg * np.pi / 180.

    c2ws = src.c2ws[sel].copy()
    c2ws[..., :2, -1] = 0.
    z_t = z_t * c2ws[0, 2, -1]
    focals = src.focals_at(sel)[:, None].repeat(n_step, 1).reshape(-1)

    motions = np.linspace(0., 2 * np.pi, n_step, endpoint=True)
    x_motions = (np.cos(motions) - 1.) * x_rad
    y_motions = np.sin(motions) * y_rad
    z_trans = (np.sin(motions) + 1.) * z_t

    bubble_c2ws = []
    for c2w in c2ws:
        for xm, ym, zt in zip(x_motions, y_motions, z_trans):
            c = c2w.copy()
            c[2, -1] += zt
            bubble_c2ws.append(rotate_x(xm) @ rotate_y(ym) @ c)

    kps, bones = src.kps[sel].copy(), src.bones[sel].copy()
    cam_idxs = (sel if idx_map is None else np.asarray(idx_map)[sel]
                )[:, None].repeat(n_step, 1).reshape(-1)
    kps = kps - kps[..., :1, :]
    kps, skts = _fk_many(bones, src.rest_pose, kps[..., :1, :].copy())
    n_sel = len(sel)
    kps = kps[:, None].repeat(n_step, 1).reshape(n_sel * n_step, -1, 3)
    skts = skts[:, None].repeat(n_step, 1).reshape(n_sel * n_step, -1, 4, 4)
    return {'kp3d': kps, 'skts': skts,
            'bones': bones[:, None].repeat(n_step, 1).reshape(
                n_sel * n_step, -1, 3),
            'c2ws': np.array(bubble_c2ws).reshape(-1, 4, 4),
            'cam_idxs': cam_idxs, 'focals': focals}
