"""Skeleton-relative input encoders, torch (port of
anerf_tpu/ops/encoding.py): the flat joint-major path the flagship's
reldist / reldir / relray family takes, and the (R, S, J, 3) path with
every encoder kind of the JAX package.

Shapes: pts (R, S, 3), skts (R, J, 4, 4), kps (R, J, 3), rays_d
(R, 1, 3). Geometry is written as explicit fp32 multiply-adds (no
matmul), so it never takes a TF32 path on the GPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

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


def transform_batch_pts(pts: torch.Tensor, skts: torch.Tensor
                        ) -> torch.Tensor:
    """World points -> per-joint local coordinates, (R, S, J, 3):
    out[r, s, j, a] = sum_b skts[r, j, a, b] * pts[r, s, b] + t[r, j, a]."""
    return (transform_batch_rays(pts, skts)
            + skts[:, None, :, :3, 3])


def transform_batch_rays(rays_d: torch.Tensor, skts: torch.Tensor
                         ) -> torch.Tensor:
    """Directions -> per-joint local frames (rotation only): rays_d
    (R, S, 3), skts (R, J, 4, 4) -> (R, S, J, 3)."""
    rot = skts[:, None, :, :3, :3]                           # (R, 1, J, 3, 3)
    p = rays_d[:, :, None, None, :]                          # (R, S, 1, 1, 3)
    return ((rot[..., 0] * p[..., 0] + rot[..., 1] * p[..., 1])
            + rot[..., 2] * p[..., 2])


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False
          ) -> torch.Tensor:
    """2-norm whose gradient at 0 is 0 (a point on a joint)."""
    return torch.linalg.vector_norm(v, dim=dim, keepdim=keepdim)


def _normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-12
               ) -> torch.Tensor:
    return v / torch.clamp_min(_norm(v, axis, keepdim=True), eps)


def calculate_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between vectors minus pi / 2, its cosine clamped to
    [-1 + 1e-6, 1 - 1e-6] so that arccos' gradient stays finite."""
    dot = (a * b).sum(-1)
    cos = dot / torch.clamp_min(_norm(a) * _norm(b), 1e-12)
    cos = torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6)
    return torch.arccos(cos) - 0.5 * math.pi


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """One encoder: its name, output width and function. The flat path
    (render/raycaster.py) reads only the name and width."""
    name: str
    dims: int
    fn: Callable = dataclasses.field(compare=False, hash=False, repr=False,
                                     default=None)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


# ----- keypoint (v) encoders: (pts, pts_t, kps) -> (R, S, dims) -----

def make_kp_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                    ) -> Tuple[EncoderSpec, int, int]:
    """Returns (spec, input_dims, cutoff_dims)."""
    J = skel.n_joints
    if kind == 'reldist':
        def fn(pts, pts_t, kps):
            if pts_t is not None:
                return _norm(pts_t)
            return _norm(pts[:, :, None] - kps[:, None])
        return EncoderSpec('RelDist', J, fn), J, J
    if kind == 'relpos':
        def fn(pts, pts_t, kps):
            if pts_t is not None:
                return pts_t.reshape(*pts_t.shape[:-2], J * 3)
            rel = pts[:, :, None] - kps[:, None]
            return rel.reshape(*rel.shape[:-2], J * 3)
        return EncoderSpec('RelPos', J * 3, fn), J * 3, J
    if kind == 'cat':
        def fn(pts, pts_t, kps):
            kpe = kps.reshape(kps.shape[0], 1, J * 3).expand(
                *pts.shape[:2], J * 3)
            return torch.cat([pts, kpe], -1)
        return EncoderSpec('KPCat', J * 3 + 3, fn), J * 3 + 3, J
    if kind == 'querypts':
        return EncoderSpec('Identity', 3, lambda pts, pts_t, kps: pts), 3, 3
    raise NotImplementedError(f'kp_dist_type {kind} not implemented')


# ----- bone (r) encoders: (pts_t, bones, refs) -> (R, S, dims) -----

def make_bone_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                      ) -> Tuple[EncoderSpec, int]:
    J = skel.n_joints
    if kind == 'reldir':
        def fn(pts_t, bones=None, refs=None):
            n = _normalize(pts_t)
            return n.reshape(*n.shape[:2], -1)
        return EncoderSpec('VecNorm', J * 3, fn), J * 3
    if kind == 'axisang':
        def fn(pts_t, bones=None, refs=None):
            R, S = (refs if refs is not None else pts_t).shape[:2]
            b = bones.reshape(R, 1, -1)
            return b.expand(R, S, b.shape[-1])
        return EncoderSpec('IdentityExpand', J * 3, fn), J * 3
    if kind == 'Nope':
        return EncoderSpec('Nope', 0, lambda *a, **k: None), 0
    raise NotImplementedError(f'bone_type {kind} not implemented')


# ----- view (d) encoders: (rays_t, pts_t, refs) -> (R, S | 1, dims) -----

def make_view_encoder(kind: str, skel: Skeleton = SMPLSkeleton
                      ) -> Tuple[EncoderSpec, int]:
    """'world' reads the world-frame ray direction (R, 1, 3), which
    render/raycaster.py:encode_inputs passes it in place of the per-joint
    rays; the others read the per-joint rays (R, 1, J, 3)."""
    J = skel.n_joints
    if kind == 'relray':
        def fn(rays_t, pts_t=None, refs=None):
            n = _normalize(rays_t)
            n = n.reshape(*n.shape[:2], -1)                  # (R, 1, J*3)
            if refs is not None:
                n = n.expand(*refs.shape[:2], n.shape[-1])
            return n
        return EncoderSpec('VecNorm', J * 3, fn), J * 3
    if kind == 'rayangle':
        def fn(rays_t, pts_t=None, refs=None):
            return calculate_angle(pts_t, rays_t)
        return EncoderSpec('RayAng', J, fn), J
    if kind == 'world':
        def fn(rays_t, pts_t=None, refs=None):
            R, S = refs.shape[:2]
            r = rays_t.reshape(R, 1, -1)
            return r.expand(R, S, r.shape[-1])
        return EncoderSpec('IdentityExpand', 3, fn), 3
    raise NotImplementedError(f'view_type {kind} not implemented')
