"""Skeleton-relative input encoders, torch (port of
anerf_tpu/ops/encoding.py: the flat joint-major path and the reldist /
reldir / relray encoders the flagship uses).

Shapes: pts (R, S, 3), skts (R, J, 4, 4), rays_d (R, 1, 3). Geometry is
written as explicit fp32 multiply-adds (no matmul), so it never takes a
TF32 path on the GPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..skeleton import Skeleton, SMPLSkeleton


def rot_cols(skts: torch.Tensor) -> torch.Tensor:
    """(R, J, 4, 4) -> (R, 3, J*3): rot_cols[r, b, j*3+a] = skts[r, j, a, b]."""
    R, J = skts.shape[0], skts.shape[1]
    return skts[..., :3, :3].permute(0, 3, 1, 2).reshape(R, 3, J * 3)


def rotate_flat(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x (R, S, 3), cols (R, 3, C) -> (R, S, C) = sum_b x[..., b] cols[b]."""
    return (x[..., 0:1] * cols[:, None, 0] + x[..., 1:2] * cols[:, None, 1]
            + x[..., 2:3] * cols[:, None, 2])


def transform_batch_pts_flat(pts: torch.Tensor, skts: torch.Tensor
                             ) -> torch.Tensor:
    """World points -> per-joint local coords, flat joint-major (R, S, J*3):
    out[r, s, j*3+a] = sum_b skts[r, j, a, b] * pts[r, s, b] + t[r, j, a]."""
    R, J = skts.shape[0], skts.shape[1]
    trans = skts[..., :3, 3].reshape(R, 1, J * 3)
    return rotate_flat(pts, rot_cols(skts)) + trans


def _group3_sumsq(x_flat: torch.Tensor, J: int) -> torch.Tensor:
    """Sum of squares over consecutive triples: (..., J*3) -> (..., J)."""
    x = x_flat.reshape(*x_flat.shape[:-1], J, 3)
    return (x * x).sum(-1)


def _expand3(x: torch.Tensor, J: int) -> torch.Tensor:
    """(..., J) -> (..., J*3) joint-major repeat."""
    return x.repeat_interleave(3, dim=-1)


# The port computes the encodings on the flat joint-major path
# (raycaster.encode_inputs, and K1), so an encoder maker returns the
# encoder's name and widths where the JAX package returns a callable.

def make_kp_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                    ) -> Tuple[str, int, int]:
    """Returns (name, input_dims, cutoff_dims). Only 'reldist' (the
    flagship's) is ported; the other kinds wait for a later slice."""
    J = skel.n_joints
    if kind == 'reldist':
        return 'RelDist', J, J
    raise NotImplementedError(f'kp_dist_type {kind} not ported yet')


def make_bone_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                      ) -> Tuple[str, int]:
    """Returns (name, dims) for 'reldir' (unit bone directions) or 'Nope'."""
    if kind == 'reldir':
        return 'VecNorm', skel.n_joints * 3
    if kind == 'Nope':
        return 'Nope', 0
    raise NotImplementedError(f'bone_type {kind} not ported yet')


def make_view_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                      ) -> Tuple[str, int]:
    """Returns (name, dims) for 'relray' (per-joint unit ray directions)."""
    if kind == 'relray':
        return 'VecNorm', skel.n_joints * 3
    raise NotImplementedError(f'view_type {kind} not ported yet')
