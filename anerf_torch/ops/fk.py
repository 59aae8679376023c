"""Forward kinematics, level-parallel, torch (port of anerf_tpu/ops/fk.py).

Joints are grouped by tree depth (Skeleton.levels); each level is one
batched 4x4 product against its parents' transforms. Small products are
written as explicit fp32 multiply-sums, so geometry never takes a TF32
matmul path on the GPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..skeleton import Skeleton, SMPLSkeleton, smpl_rest_pose
from .rotations import bones_to_rot


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k) @ (..., k, m) as an exact-fp32 multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def rigid_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Invert rigid homogeneous transforms (..., 4, 4) without a solver."""
    rot_t = mats[..., :3, :3].transpose(-1, -2)
    t = mats[..., :3, 3:]
    top = torch.cat([rot_t, -_mm(rot_t, t)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mats.dtype,
                          device=mats.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _to_homo(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype,
                          device=rot.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def fk(bones: torch.Tensor, rest_pose: torch.Tensor,
       pelvis: Optional[torch.Tensor] = None,
       skel: Skeleton = SMPLSkeleton,
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """bones (N, J, 3|6), rest_pose (J, 3) or (N, J, 3), pelvis (N, 3).

    Returns kp3d (N, J, 3), skts (N, J, 4, 4) world-to-local,
    l2ws (N, J, 4, 4) local-to-world and rots (N, J, 3, 3).
    """
    N, J = bones.shape[:2]
    if rest_pose.dim() == 2:
        rest_pose = rest_pose[None]
    rest_pose = rest_pose.expand(N, J, 3)
    rots = bones_to_rot(bones)

    root = skel.root_id
    parents = list(skel.joint_trees)
    offsets = rest_pose - rest_pose[:, parents]
    offsets = offsets.clone()
    offsets[:, root] = rest_pose[:, root]
    rel = _to_homo(rots, offsets)

    l2w = torch.zeros((N, J, 4, 4), dtype=bones.dtype, device=bones.device)
    l2w[:, root] = rel[:, root]
    for level in skel.levels[1:]:
        idx = list(level)
        pidx = [parents[j] for j in idx]
        l2w[:, idx] = _mm(l2w[:, pidx], rel[:, idx])

    if pelvis is not None:
        l2w[..., :3, 3] += pelvis[:, None, :]

    skts = rigid_inverse(l2w)
    kp3d = l2w[..., :3, 3]
    return kp3d, skts, l2w, rots


def get_smpl_l2ws_np(pose: np.ndarray, rest_pose: np.ndarray | None = None,
                     scale: float = 1.0,
                     skel: Skeleton = SMPLSkeleton,
                     use_rot_mats: bool = False) -> np.ndarray:
    """Host-side numpy FK for one (J, 3) axis-angle pose (or (J, 3, 3)
    rotation matrices when use_rot_mats) -> (J, 4, 4) local-to-world."""
    from scipy.spatial.transform import Rotation

    if rest_pose is None:
        rest_pose = smpl_rest_pose
    rest_kp = rest_pose * scale
    if use_rot_mats:
        mrots = np.asarray(pose, np.float32)
    else:
        mrots = np.stack([Rotation.from_rotvec(p).as_matrix()
                          for p in pose]).astype(np.float32)

    def mat_to_homo(mat):
        return np.concatenate(
            [mat, np.array([[0, 0, 0, 1]], dtype=np.float32)], axis=0)

    joint_trees = skel.joint_trees
    root = skel.root_id
    l2ws = [None] * len(rest_kp)
    l2ws[root] = mat_to_homo(
        np.concatenate([mrots[root], rest_kp[root][:, None]], axis=-1))
    for level in skel.levels[1:]:
        for j in level:
            parent = joint_trees[j]
            rel = mat_to_homo(np.concatenate(
                [mrots[j], (rest_kp[j] - rest_kp[parent])[:, None]], axis=-1))
            l2ws[j] = l2ws[parent] @ rel
    return np.stack(l2ws).astype(np.float32)
