"""Offline SURREAL raw-dump -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_surreal.py).

Re-design of reference core/load_surreal.py:17-300 (process_surreal_data and
helpers): reads per-sequence metadata.pkl + segm .mat + image sequences from
a SURREAL render dump, applies the SURREAL->framework coordinate conversions
(global flip + root-bone rotation), builds skts/cylinders, restricts
sampling masks to the cylinder's 2D projection, and writes the canonical h5.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..ops.rays import get_rays_np
from ..skeleton import SMPLSkeleton, smpl_rest_pose
from .process_mask import dilate_masks
from .schema import write_h5

# fixed scale that roughly matches skeleton ranges across datasets
# (reference load_surreal.py:18)
DATASET_EXT_SCALE = 0.25 / 0.00035

# SURREAL -> framework coordinate conversions (load_surreal.py:103-111)
ROT_ROOTBONE = np.array([[1., 0., 0.],
                         [0., 0., -1.],
                         [0., 1., 0.]], np.float32)
ROT_GLOB = np.array([[1., 0., 0., 0.],
                     [0., -1., 0., 0.],
                     [0., 0., -1., 0.],
                     [0., 0., 0., 1.]], np.float32)
# shape parameters used by the SURREAL generator (load_surreal.py:112-115)
SURREAL_BETA = np.array(
    [-0.8010307, 0.6838105, 0.7480726, -1.1379223, -0.32415348,
     -0.8404733, -0.4795286, -0.63125765, -0.13453396, 1.4934114],
    np.float32).reshape(1, 10)


def get_img_cam_indices(n_imgs: int, n_seqs: int, n_kps: int,
                        n_kp_per_seq: int,
                        seq_cam_type: np.ndarray) -> np.ndarray:
    """Camera row per image in the (cams_per_type, seqs*poses) layout
    (load_surreal.py:61-77)."""
    n_cams_per_type = int(n_imgs / (n_seqs * n_kp_per_seq))
    idx = np.arange(n_cams_per_type).reshape(-1, 1, 1)
    idx = idx.repeat(n_seqs, 1).repeat(n_kp_per_seq, 2)
    idx = idx + seq_cam_type[None, :, None] * n_cams_per_type
    return idx.reshape(-1)


def _rotate_root_bones(bones: np.ndarray) -> np.ndarray:
    """Compose ROT_ROOTBONE into each root axis-angle
    (load_surreal.py:230-235)."""
    from scipy.spatial.transform import Rotation
    roots = bones[:, 0]
    rots = Rotation.from_rotvec(roots).as_matrix()
    new = Rotation.from_matrix(ROT_ROOTBONE[None] @ rots).as_rotvec()
    out = bones.copy()
    out[:, 0] = new
    return out


def restrict_mask_to_cylinder(sampling_masks: np.ndarray,
                              cylinders: np.ndarray,
                              img_cam_indices: np.ndarray,
                              c2ws_per_cam: np.ndarray,
                              focal: float) -> np.ndarray:
    """Zero sampling-mask pixels whose rays miss the bounding cylinder's 2D
    circle (load_surreal.py:250-268)."""
    H, W = sampling_masks.shape[1:3]
    n_kps = len(cylinders)
    rays_per_cam = [get_rays_np(H, W, focal, c2w) for c2w in c2ws_per_cam]
    out = sampling_masks.copy()
    for i in range(len(out)):
        cyl = cylinders[i % n_kps]
        rays_o, rays_d = rays_per_cam[img_cam_indices[i]]
        ro = rays_o.reshape(-1, 3)[:, [0, -1]]
        rd = rays_d.reshape(-1, 3)[:, [0, -1]]
        far = ro + rd * 100.0
        of = far - ro
        od = cyl[:2] - ro
        cross = of[:, 0] * od[:, 1] - of[:, 1] * od[:, 0]
        dist = np.abs(cross) / np.linalg.norm(of, axis=-1)
        hit = (dist < cyl[2]).reshape(H, W).astype(np.uint8)
        out[i, ..., 0] *= hit
    return out


def process_surreal_data(h5_file: str, data_path: str,
                         extend_iter: int = 2,
                         ext_scale: float = 0.001) -> dict:
    """Convert a raw SURREAL dump under `data_path` (sequence dirs named
    *_*/ with metadata.pkl, *-*/ *segm.mat, *-*/imageSequences/*.png) to the
    canonical h5 at `h5_file`."""
    import imageio.v2 as imageio
    from scipy.io import loadmat

    ext_scale = DATASET_EXT_SCALE * ext_scale
    sg = lambda p: sorted(glob.glob(p))
    data_dirs = sg(os.path.join(data_path, '*_*/'))
    assert data_dirs, f'no sequence dirs under {data_path}'

    cams, kp_3d, bone_poses = [], [], []
    render_types, seq_cam_type, focals = [], [], []
    fg_masks = imgs = None
    for i, data_dir in enumerate(data_dirs):
        with open(os.path.join(data_dir, 'metadata.pkl'), 'rb') as f:
            meta = pickle.load(f)
        focals.append(meta['focal'] * meta['int_scale'])

        render_type = meta['render_type']
        cam = np.asarray(meta['cams'])
        if render_type not in render_types:
            render_types.append(render_type)
            cam = cam.copy()
            cam[..., :3, -1] *= ext_scale
            cams.append(cam)
        seq_cam_type.append(render_types.index(render_type))

        n_kp_per_seq = meta['N_kp']
        n_cam_this_seq = meta['N_cams']
        n_cam_per_subdir = meta['N_cam_per_subdir']
        kp_3d.append(np.asarray(meta['joints3D']) * ext_scale)
        bone_poses.append(np.asarray(meta['poses']).reshape(
            n_kp_per_seq, -1, 3))

        fg_seq = []
        for fg_path in sg(os.path.join(data_dir, '*-*/', '*segm.mat')):
            m = loadmat(fg_path)['data']
            m = m.reshape(n_cam_per_subdir, n_kp_per_seq, *m.shape[-2:])
            m[m > 0] = 1
            fg_seq.append(m)
        fg_seq = np.concatenate(fg_seq, axis=0)

        if fg_masks is None:
            fg_masks = np.zeros(
                (min(n_cam_this_seq, fg_seq.shape[0]),
                 len(data_dirs) * fg_seq.shape[1], *fg_seq.shape[-2:]),
                np.uint8)
        fg_masks[:, i * fg_seq.shape[1]:(i + 1) * fg_seq.shape[1]] = \
            fg_seq[:len(fg_masks)]

        img_paths = sg(os.path.join(data_dir, '*-*/',
                                    'imageSequences/*.png'))
        img_seq = np.stack([imageio.imread(p)[..., :3] for p in img_paths])
        if imgs is None:
            imgs = np.zeros((*fg_masks.shape, 3), np.uint8)
        img_seq = img_seq.reshape(-1, n_kp_per_seq, *img_seq.shape[1:])
        imgs[:, i * n_kp_per_seq:(i + 1) * n_kp_per_seq] = \
            img_seq[:len(imgs)]

    kp_3d = np.concatenate(kp_3d).reshape(-1, 24, 3)
    bone_poses = np.concatenate(bone_poses).reshape(-1, 24, 3)
    n_kps = kp_3d.shape[0]
    focal = float(np.mean(focals))
    H, W = imgs.shape[-3:-1]
    n_seqs = len(data_dirs)

    imgs = imgs.reshape(-1, H, W, 3)
    fg_masks = fg_masks.reshape(-1, H, W)
    seq_cam_type = np.asarray(seq_cam_type)
    img_cam_indices = get_img_cam_indices(
        imgs.shape[0], n_seqs, n_kps, n_kps // n_seqs, seq_cam_type)

    sampling_masks = (fg_masks if extend_iter == 0
                      else dilate_masks(fg_masks, extend_iter))
    fg_masks = fg_masks[..., None]
    sampling_masks = sampling_masks[..., None].copy()

    c2ws = ROT_GLOB[None] @ np.concatenate(cams).reshape(-1, 4, 4)

    # bones carry their own global rotation: correct the root, flip world
    bone_poses = _rotate_root_bones(bone_poses)
    kp_3d = kp_3d @ ROT_GLOB[:3, :3].T

    l2ws = np.stack([get_smpl_l2ws_np(b, scale=ext_scale)
                     for b in bone_poses])
    l2ws[..., :3, -1] = kp_3d
    skts = np.linalg.inv(l2ws).astype(np.float32)

    cyls = get_kp_bounding_cylinder(
        kp_3d, ext_scale=ext_scale / DATASET_EXT_SCALE, skel=SMPLSkeleton,
        extend_mm=250, head='-y')

    sampling_masks = restrict_mask_to_cylinder(
        sampling_masks, cyls, img_cam_indices, c2ws, focal)

    c2ws_full = c2ws[img_cam_indices].astype(np.float32)
    data = {
        'imgs': imgs,
        'masks': fg_masks.astype(np.uint8),
        'sampling_masks': sampling_masks.astype(np.uint8),
        'bkgds': (np.ones((1, H, W, 3)) * 255).astype(np.uint8),
        'bkgd_idxs': np.zeros((len(imgs),), np.int64),
        'kp3d': kp_3d.astype(np.float32),
        'gt_kp3d': kp_3d.astype(np.float32),
        'bones': bone_poses.astype(np.float32),
        'skts': skts,
        'cyls': cyls.astype(np.float32),
        'rest_pose': (smpl_rest_pose * ext_scale).astype(np.float32),
        'betas': SURREAL_BETA,
        'c2ws': c2ws_full,
        'focals': np.full((len(imgs),), focal, np.float32),
        'ext_scale': float(ext_scale),
    }
    write_h5(h5_file, data)
    return data
