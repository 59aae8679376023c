"""Rotation representation conversions in torch (port of
anerf_tpu/ops/rotations.py, the forward conversions FK needs).

Conventions match the reference exactly:
  * axis-angle -> rotation matrix via Rodrigues (Taylor branch near 0).
  * 6D representation is the first two COLUMNS of the rotation matrix,
    flattened row-major from a (3, 2) block.
  * rot6d -> rotmat via Gram-Schmidt (Zhou et al. CVPR'19).
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


def bones_to_rot(bones: torch.Tensor) -> torch.Tensor:
    """Dispatch on trailing dim: 3 = axis-angle, 6 = 6D."""
    if bones.shape[-1] == 3:
        return axisang_to_rot(bones)
    if bones.shape[-1] == 6:
        return rot6d_to_rot(bones)
    raise NotImplementedError(f'bone dim {bones.shape[-1]} unsupported')
