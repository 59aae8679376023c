"""SPIN estimate -> framework dataset conversion
(torch port's copy of anerf_tpu/data/process_spin.py).

Re-design of reference core/process_spin.py:14-232: converts SPIN SMPL
estimates (betas, weak-perspective cameras, joints, rotation matrices,
bboxes) into the canonical h5 schema: rest pose from betas (via smplx when
available), bone-length rescaling to the canonical scale, weak-perspective ->
full-perspective camera recovery (VIBE-style), bounding cylinders.

smplx (and its SMPL model files) are external assets; when absent, callers
can pass a precomputed rest pose instead of betas.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..ops.rays import swap_mat
from ..skeleton import SMPLSkeleton, smpl_rest_pose

# identity mapper over the 24 SMPL joints (process_spin.py:12)
SMPL_JOINT_MAPPER = lambda joints: joints[:, list(range(24))]


def calculate_bone_length(pose: np.ndarray,
                          skel=SMPLSkeleton) -> np.ndarray:
    """Per-bone lengths of a rest pose (J-1,)."""
    parents = np.asarray(skel.joint_trees)
    nonroot = [j for j in range(skel.n_joints) if j != skel.root_id]
    return np.linalg.norm(pose[nonroot] - pose[parents[nonroot]], axis=-1)


def convert_crop_cam_to_orig_img_and_focal(
        cam: np.ndarray, bbox: np.ndarray, img_width: int, img_height: int,
        focal: float = 5000., resized_width: int = 224,
        resized_height: int = 224,
        new_focal: Optional[float] = None) -> np.ndarray:
    """Weak-perspective camera in crop coords -> (focal, tx, ty, cz) in the
    original image (VIBE-derived math; process_spin.py:46-95).

    cam: (N, 3) [s, tx, ty]; bbox: (N, 3+) [cx, cy, h].
    """
    cam = np.asarray(cam, np.float64)
    bbox = np.asarray(bbox, np.float64)
    cz = 2 * focal / (resized_width * cam[:, 0])
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2., img_height / 2.

    f = h / resized_width * focal
    sx = cam[:, 0] * (1. / (img_width / h))
    sy = cam[:, 0] * (1. / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]

    if new_focal is not None:
        cz = cz * new_focal / f
        f = np.full_like(f, new_focal)
    return np.stack([f, tx, ty, cz], axis=-1)


def rest_pose_from_betas(betas: np.ndarray, gender: str = 'NEUTRAL',
                         mapper=SMPL_JOINT_MAPPER,
                         model_path: Optional[str] = None,
                         tables=None) -> np.ndarray:
    """Mean zero-pose SMPL joints for the given shape parameters
    (process_spin.py:110-127), root-centered and averaged over frames.

    Resolution order: precomputed joint tables (the `tables` dict or
    $ANERF_SMPL_TABLES — see data/smpl_tables.py; exactly
    J_regressor @ shaped template, same numbers smplx produces), else
    smplx + the SMPL model files."""
    from .smpl_tables import ENV_VAR, SMPLTablesMissing, joints_from_betas
    import os as _os

    betas_np = np.asarray(betas, np.float32)
    if betas_np.ndim == 1:
        betas_np = betas_np[None]

    if tables is not None or _os.environ.get(ENV_VAR):
        if tables is None:
            from .smpl_tables import load_tables
            tables = load_tables()
        rest_poses = joints_from_betas(betas_np, tables)
        rest_poses = rest_poses - rest_poses[:, 0:1]
        return rest_poses.mean(0).astype(np.float32)

    try:
        import torch
        from smplx import SMPL
    except ImportError as e:
        raise SMPLTablesMissing(
            'rest_pose_from_betas needs either smplx + SMPL model files or '
            f'the precomputed joint tables ({ENV_VAR}; see '
            'anerf_torch/data/smpl_tables.py and tools/real_data_runbook.md)'
        ) from e

    betas_t = torch.tensor(betas_np)
    with torch.no_grad():
        dummy = torch.eye(3).view(1, 1, 3, 3).expand(len(betas_t), 24, 3, 3)
        smpl = SMPL(model_path or f'smpl/SMPL_{gender}.pkl',
                    joint_mapper=mapper)
        out = smpl(betas=betas_t, body_pose=dummy[:, 1:],
                   global_orient=dummy[:, :1], pose2rot=False)
        rest_poses = out.joints.cpu().numpy()
    rest_poses -= rest_poses[:, 0:1]
    return rest_poses.mean(0)


def get_keypoints_from_rest_pose(rest_pose: np.ndarray,
                                 joints: np.ndarray,
                                 rot_mats: np.ndarray,
                                 ext_scale: float = 1.0,
                                 align_joint_idx: int = 8,
                                 ref_pose: np.ndarray = smpl_rest_pose,
                                 scale_rest_pose: bool = True):
    """FK the SPIN rotations through a rest pose, rescaled so mean bone
    length matches the canonical reference pose (process_spin.py:97-155)."""
    from scipy.spatial.transform import Rotation

    if scale_rest_pose:
        ref = ref_pose * ext_scale
        pose_scale = (calculate_bone_length(ref).mean()
                      / calculate_bone_length(rest_pose).mean())
    else:
        pose_scale = 1.0
    rest_pose = rest_pose * pose_scale

    pelvis = np.asarray(joints)[:, align_joint_idx] * pose_scale  # (N, 3)
    bones = Rotation.from_matrix(
        np.asarray(rot_mats).reshape(-1, 3, 3)).as_rotvec().reshape(
            -1, 24, 3).astype(np.float32)

    l2ws = np.array([get_smpl_l2ws_np(b, rest_pose=rest_pose) for b in bones])
    l2ws[:, :, :3, -1] += pelvis.reshape(-1, 1, 3)
    kp3d = l2ws[:, :, :3, -1].copy()
    skts = np.linalg.inv(l2ws)
    return kp3d, bones, skts, rest_pose, pose_scale


def pred_cams_to_orig_cam_params(cameras, bboxes, img_width=512,
                                 img_height=512, resized_width=224,
                                 resized_height=224, focal=5000.,
                                 ext_scale=1.0, new_focal=None):
    """(focals, c2ws) in NeRF convention (process_spin.py:157-179)."""
    orig = convert_crop_cam_to_orig_img_and_focal(
        cameras, bboxes, img_width, img_height, focal,
        resized_width, resized_height, new_focal)
    focals = orig[:, 0]
    cam_t = orig[:, 1:] * ext_scale
    c2ws = np.eye(4, dtype=np.float32)[None].repeat(len(orig), 0)
    c2ws[:, :3, -1] = -cam_t
    return focals.astype(np.float32), swap_mat(c2ws).astype(np.float32)


def process_spin_data(betas, cameras, joints, rot_mats, bboxes,
                      ref_pose: np.ndarray = smpl_rest_pose,
                      align_joint_idx: int = 8, focal: float = 5000,
                      res=512, resized_res: int = 224,
                      ext_scale: float = 0.001,
                      dataset_ext_scale: float = 0.25 / 0.00035,
                      scale_rest_pose: bool = True,
                      new_focal: Optional[float] = None,
                      rest_pose: Optional[np.ndarray] = None,
                      skel=SMPLSkeleton) -> Dict[str, np.ndarray]:
    """Full SPIN -> dataset conversion (process_spin.py:182-232).

    rest_pose: precomputed (J, 3) rest pose; when None it is derived from
    betas via smplx.
    """
    res_H, res_W = (res, res) if isinstance(res, int) else res
    ext_scale = ext_scale * dataset_ext_scale

    if rest_pose is None:
        rest_pose = rest_pose_from_betas(betas)

    kp3d, bones, skts, rest_pose, pose_scale = get_keypoints_from_rest_pose(
        rest_pose, joints, rot_mats, ext_scale, align_joint_idx, ref_pose,
        scale_rest_pose)

    cyls = get_kp_bounding_cylinder(
        kp3d, ext_scale=ext_scale / dataset_ext_scale, skel=skel,
        extend_mm=250, head='-y')

    focals, c2ws = pred_cams_to_orig_cam_params(
        cameras, bboxes, img_width=res_W, img_height=res_H,
        resized_width=resized_res, resized_height=resized_res, focal=focal,
        ext_scale=pose_scale, new_focal=new_focal)

    return {'kp3d': kp3d.astype(np.float32),
            'bones': bones.astype(np.float32),
            'cyls': cyls.astype(np.float32),
            'skts': skts.astype(np.float32),
            'rest_pose': rest_pose.astype(np.float32),
            'ext_scale': float(ext_scale),
            'c2ws': c2ws, 'focals': focals,
            'pose_scale': float(pose_scale)}


def _load_spin_file(data_path: str) -> dict:
    """Read a SPIN output pack: .pkl, or an hdf5 of flat arrays (the
    deepdish-written packs the reference consumes read fine through h5py
    for their array-valued keys)."""
    if data_path.endswith('.pkl'):
        with open(data_path, 'rb') as f:
            return pickle.load(f)
    import h5py
    out = {}
    with h5py.File(data_path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                key = name.split('/')[-1]
                out.setdefault(key, obj[()])
        f.visititems(visit)
    return out


def read_spin_data(data_path: str, ext_scale: float = 0.001,
                   img_res: int = 1000, bbox_res: int = 224,
                   rest_pose: Optional[np.ndarray] = None,
                   subject_filter: Optional[str] = None):
    """Read a SPIN output pack and convert (process_spin.py:14-42).

    subject_filter: keep only frames whose img_path contains the string
    (multi-subject packs like 3DHP's, reference load_3dhp.py:25-31).
    """
    spin = _load_spin_file(data_path)
    betas = np.asarray(spin['pred_betas'])
    joints = np.asarray(spin['joints'] if 'joints' in spin
                        else spin['pred_joints'])
    rot_mats = np.asarray(spin['pred_rot_mat'])
    bboxes = np.asarray(spin['bbox_params'])
    cameras = np.asarray(spin.get('pred_camera', spin.get('pred_cam')))

    if subject_filter is not None:
        paths = [p.decode() if isinstance(p, bytes) else str(p)
                 for p in spin['img_path']]
        keep = np.array([i for i, p in enumerate(paths)
                         if subject_filter in p], np.int64)
        betas, joints = betas[keep], joints[keep]
        rot_mats, bboxes, cameras = rot_mats[keep], bboxes[keep], \
            cameras[keep]
        spin = dict(spin)
        spin['img_path'] = np.asarray(paths)[keep]
        if 'pose_3d' in spin:
            spin['pose_3d'] = np.asarray(spin['pose_3d'])[keep]

    out = process_spin_data(betas, cameras, joints, rot_mats, bboxes,
                            res=img_res, resized_res=bbox_res,
                            ext_scale=ext_scale, rest_pose=rest_pose)
    out['img_path'] = spin.get('img_path')
    if 'pose_3d' in spin:
        out['gt_kp3d'] = np.asarray(spin['pose_3d'], np.float32)
    out['betas'] = betas
    return out
