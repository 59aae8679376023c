"""Trainable per-frame pose refinement as plain tensor dicts + functions
(torch port of anerf_tpu/pose/pose_opt.py).

The pose parameters are {'pelvis': (N, 3), 'bones': (N, J, 3|6)} (with
multi-view sharing, 'root_bones' (N, 3|6) and 'bones' (U, J-1, 3|6)).
`fk_lookup` gathers the batch's frames and runs level-parallel FK
(ops/fk.py, plain torch); the RGB loss reaches the pose parameters by
ordinary autograd through the skeleton-relative encodings. The
dual-optimizer stepping rules live in train/trainer.py.

The batch's rows of the pose tables are gathered by `gather_rows`, whose
backward sums a row's cotangents in a fixed order (the order the rows
occur in the batch) on every device: with multi-view sharing, the 4 views
of an instant read one 'bones' row, and a repeated image repeats every
row, so the gradient is a sum over duplicate rows that must come out the
same bits on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.fk import fk, get_smpl_l2ws_np
from ..ops.rotations import axisang_to_rot, rot6d_to_axisang, rot_to_rot6d
from ..skeleton import Skeleton, SMPLSkeleton


@dataclasses.dataclass(frozen=True)
class PoseOptConfig:
    """Static pose-opt configuration (subset of the reference flags)."""
    use_rot6d: bool = False
    skel: Skeleton = SMPLSkeleton
    multiview: bool = False


def init_pose_params(kp3d: np.ndarray, bones: np.ndarray,
                     cfg: PoseOptConfig,
                     kp_map: Optional[np.ndarray] = None,
                     kp_uidxs: Optional[np.ndarray] = None,
                     device='cuda') -> Dict[str, torch.Tensor]:
    """The trainable pose tree from initial estimates: kp3d (N, J, 3)
    (pelvis = root joint), bones (N, J, 3) axis-angle; kp_map / kp_uidxs
    are the multi-view sharing tables (or None)."""
    dev = resolve_device(device)
    root = cfg.skel.root_id
    pelvis = torch.as_tensor(np.asarray(kp3d[:, root], np.float32))
    b = torch.as_tensor(np.asarray(bones, np.float32))
    if cfg.use_rot6d:
        b = rot_to_rot6d(axisang_to_rot(b))
    params = {'pelvis': pelvis.to(dev)}
    if kp_map is None:
        params['bones'] = b.to(dev)
    else:
        params['root_bones'] = b[:, root].to(dev)
        params['bones'] = b[torch.as_tensor(np.asarray(kp_uidxs)),
                            root + 1:].to(dev)
    return params


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward is a sort-and-segment sum: the stable
    sort of idx keeps each row's cotangents in batch order, per-row counts
    come from an integer scatter (exact in any order) and
    torch.segment_reduce adds each segment sequentially from 0. That is
    the order and the value of autograd's own CPU backward of indexing (a
    serial accumulating index_put_), and on a GPU it involves no float
    atomics."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        order = torch.argsort(idx, stable=True)
        counts = torch.zeros(ctx.n_rows, dtype=torch.int64,
                             device=idx.device).scatter_add_(
            0, idx, torch.ones_like(idx))
        return torch.segment_reduce(g[order], 'sum', lengths=counts,
                                    axis=0), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-d index, with a deterministic backward
    (_GatherRows)."""
    return _GatherRows.apply(table, idx)


def pose_params_to_bones(params: Dict[str, torch.Tensor],
                         idxs: torch.Tensor, cfg: PoseOptConfig,
                         kp_map: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather (pelvis, bones) for frame indices (reference idx_to_params,
    pose_opt.py:318-332)."""
    pelvis = gather_rows(params['pelvis'], idxs)
    if kp_map is None:
        return pelvis, gather_rows(params['bones'], idxs)
    root_bones = gather_rows(params['root_bones'], idxs)[:, None]
    bones = gather_rows(params['bones'], kp_map[idxs])
    return pelvis, torch.cat([root_bones, bones], 1)


def fk_lookup(params: Dict[str, torch.Tensor], idxs: torch.Tensor,
              rest_pose: torch.Tensor, cfg: PoseOptConfig,
              kp_map: Optional[torch.Tensor] = None,
              rest_pose_idxs: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, ...]:
    """FK for the given (already unique, per-batch) frame indices.
    rest_pose (1|S, J, 3); with several subjects, rest_pose_idxs
    (N_frames,) maps each frame to its subject's rest pose.
    Returns (kps, bones, skts, l2ws, rots)."""
    pelvis, bones = pose_params_to_bones(params, idxs, cfg, kp_map)
    if rest_pose.dim() == 3 and rest_pose.shape[0] > 1:
        if rest_pose_idxs is None:
            raise ValueError('multi-subject rest poses need rest_pose_idxs')
        rest = rest_pose[rest_pose_idxs[idxs]]
    else:
        rest = rest_pose.reshape(-1, rest_pose.shape[-2], rest_pose.shape[-1])
    kp3d, skts, l2ws, rots = fk(bones, rest, pelvis, cfg.skel)
    return kp3d, bones, skts, l2ws, rots


def get_bones_axisang(params: Dict[str, torch.Tensor], cfg: PoseOptConfig
                      ) -> torch.Tensor:
    """All bones as axis-angle (for export)."""
    bones = params['bones']
    return rot6d_to_axisang(bones) if cfg.use_rot6d else bones


def get_noisy_bones(bones: np.ndarray, noise_degree: float,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Add half-masked gaussian noise to axis-angle bones
    (reference skeleton_utils.py:289-295)."""
    rng = rng or np.random.default_rng()
    scale = np.pi / 180.0 * noise_degree
    mask = (rng.random(bones.shape) > 0.5).astype(np.float32)
    return bones + rng.normal(0, scale, bones.shape) * mask


def perturb_poses(bones: np.ndarray, kp3d: np.ndarray,
                  rest_pose: np.ndarray,
                  noise_degree: float = 0.1,
                  noise_pelvis_mm: Optional[float] = None,
                  ext_scale: float = 0.001,
                  rng: Optional[np.random.Generator] = None,
                  skel: Skeleton = SMPLSkeleton):
    """Simulate noisy pose estimates for pose-refinement experiments
    (reference perturb_poses, skeleton_utils.py:297-321).
    Returns (noisy_bones, noisy_skts, noisy_kp3d)."""
    rng = rng or np.random.default_rng()
    noisy_bones = (bones if noise_degree is None
                   else get_noisy_bones(bones, noise_degree, rng))
    pelvis = kp3d[:, skel.root_id].copy()
    if noise_pelvis_mm is not None:
        pelvis += rng.normal(scale=noise_pelvis_mm * ext_scale,
                             size=pelvis.shape)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose, skel=skel)
                     for b in noisy_bones])
    l2ws[:, :, :3, -1] += pelvis[:, None]
    noisy_skts = np.linalg.inv(l2ws).astype(np.float32)
    noisy_kp = l2ws[:, :, :3, -1].astype(np.float32)
    return noisy_bones.astype(np.float32), noisy_skts, noisy_kp


def pose_anchor_tree(kp3d: np.ndarray, bones: np.ndarray,
                     device='cuda') -> Dict[str, torch.Tensor]:
    """Regularization anchors (reference create_popt, pose_opt.py:49-72):
    non-trainable tensors; rots recomputed from bones."""
    dev = resolve_device(device)
    b = torch.as_tensor(np.asarray(bones, np.float32))
    return {'kps': torch.as_tensor(np.asarray(kp3d, np.float32)).to(dev),
            'bones': b.to(dev), 'rots': axisang_to_rot(b).to(dev)}
