"""Rotation representation conversions in torch (port of
anerf_tpu/ops/rotations.py).

Conventions match the reference exactly:
  * axis-angle -> rotation matrix via Rodrigues (Taylor branch near 0).
  * 6D representation is the first two COLUMNS of the rotation matrix,
    flattened row-major from a (3, 2) block.
  * rot6d -> rotmat via Gram-Schmidt (Zhou et al. CVPR'19).
  * rotmat -> axis-angle through the quaternion (Shepperd's method).
"""
from __future__ import annotations

import torch


def axisang_to_rot(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta2 = torch.sum(axisang * axisang, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-30))
    small = theta2 < 1e-8
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_term = torch.where(small, 0.5 - theta2 / 24.0,
                           (1.0 - torch.cos(theta))
                           / torch.clamp_min(theta2, 1e-30))

    x, y, z = axisang[..., 0], axisang[..., 1], axisang[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    # K @ K as an explicit fp32 sum (no TF32 matmul path on the GPU)
    KK = (K[..., :, :, None] * K[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=axisang.dtype, device=axisang.device)
    return eye + sin_over[..., None] * K + cos_term[..., None] * KK


def rot6d_to_rot(x: torch.Tensor) -> torch.Tensor:
    """6D rotation rep (..., 6) -> rotation matrices (..., 3, 3)."""
    x = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = x[..., 0], x[..., 1]

    def normalize(v):
        return v / torch.clamp_min(torch.linalg.norm(v, dim=-1,
                                                     keepdim=True), 1e-12)

    b1 = normalize(a1)
    b2 = normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot_to_axisang(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_axisang(rot_to_quat(rot))


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) (w, x, y,
    z): all four Shepperd candidates, the one with the largest diagonal
    combination kept, sign canonicalized to w >= 0."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], -1),
    ], -2)                                                  # (..., 4, 4)
    mags = torch.stack([qw2, qx2, qy2, qz2], -1)
    best = torch.argmax(mags, -1, keepdim=True)             # (..., 1)
    q = torch.gather(cands, -2, best[..., None].expand(
        *best.shape[:-1], 1, 4))[..., 0, :]
    denom = 2.0 * torch.sqrt(torch.clamp_min(torch.gather(mags, -1, best),
                                             1e-30))
    q = q / denom
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_axisang(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> axis-angle (..., 3)."""
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    xyz = quat[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    half = torch.atan2(norm[..., 0], w)[..., None]
    scale = torch.where(norm < 1e-6, 2.0 + 2.0 * half * half / 6.0,
                        2.0 * half / torch.clamp_min(norm, 1e-30))
    return xyz * scale


def axisang_to_quat(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4) (w, x, y, z)."""
    theta = torch.linalg.norm(axisang, dim=-1, keepdim=True)
    half = 0.5 * theta
    sin_half_over = torch.where(theta < 1e-6, 0.5 - theta * theta / 48.0,
                                torch.sin(half)
                                / torch.clamp_min(theta, 1e-30))
    return torch.cat([torch.cos(half), axisang * sin_half_over], -1)


def rot_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> 6D rep (..., 6): first two
    columns, row-major."""
    return rot[..., :3, :2].reshape(*rot.shape[:-2], 6)


def rot6d_to_axisang(x: torch.Tensor) -> torch.Tensor:
    return rot_to_axisang(rot6d_to_rot(x))


def bones_to_rot(bones: torch.Tensor) -> torch.Tensor:
    """Dispatch on trailing dim: 3 = axis-angle, 6 = 6D."""
    if bones.shape[-1] == 3:
        return axisang_to_rot(bones)
    if bones.shape[-1] == 6:
        return rot6d_to_rot(bones)
    raise NotImplementedError(f'bone dim {bones.shape[-1]} unsupported')
