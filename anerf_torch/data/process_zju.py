"""Offline ZJU-MoCap / NeuralBody raw -> canonical h5 conversion
(torch port's copy of anerf_tpu/data/process_zju.py).

Re-design of reference core/load_zju.py:33-534: reads a NeuralBody subject
directory (annots.npy with cams/ims, mask/ + mask_cihp/, per-frame SMPL
params + vertices), undistorts, computes per-camera median backgrounds
(vectorized, vs the reference's per-pixel python loop :477-491), converts
cameras to NeRF convention with the zju->nerf ground-plane rotation, and
runs SMPL (smplx-gated) for pose data. Requires the NeuralBody release on
disk; checked on tests/rawlayout.py's synthetic subject directory.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..ops.rays import swap_mat
from ..skeleton import SMPLSkeleton
from .process_mask import dilate_masks
from .schema import write_h5

# align the ZJU ground plane to x-z (reference load_zju.py:13-15)
ZJU_TO_NERF_ROT = np.array([[1, 0, 0],
                            [0, 0, -1],
                            [0, 1, 0]], np.float32)

NUM_TRAIN_FRAMES = {'313': 60, '315': 300, '377': 300, '386': 300,
                    '387': 300, '390': 300, '392': 300, '393': 300,
                    '394': 300, '395': 300, '396': 540}


def read_mask(subject_path: str, img_path: str) -> np.ndarray:
    """Union of mask/ and mask_cihp/ person masks (load_zju.py:31-57)."""
    import imageio.v2 as imageio
    base = img_path[:-4] + '.png'
    mask = None
    for sub in ('mask', 'mask_cihp'):
        p = os.path.join(subject_path, sub, base)
        if os.path.exists(p):
            m = (imageio.imread(p) != 0).astype(np.uint8)
            mask = m if mask is None else (mask | m).astype(np.uint8)
    assert mask is not None, f'no mask for {img_path}'
    return mask


def median_backgrounds(imgs: np.ndarray, masks: np.ndarray,
                       cam_idxs: np.ndarray, num_cams: int) -> np.ndarray:
    """Per-camera per-pixel median over background pixels, vectorized."""
    H, W = imgs.shape[1:3]
    bkgds = np.zeros((num_cams, H, W, 3), np.uint8)
    for c in np.unique(cam_idxs):
        sel = cam_idxs == c
        cam_imgs = imgs[sel].astype(np.float32)
        bg = masks[sel][..., 0] < 1           # (N, H, W)
        masked = np.ma.masked_array(
            cam_imgs, mask=np.broadcast_to(~bg[..., None], cam_imgs.shape))
        med = np.ma.median(masked, axis=0).filled(0)
        bkgds[c] = med.astype(np.uint8)
    return bkgds


def get_smpls(subject_path: str, kp_ids: Sequence[int],
              model_path: str, param_dir: str = 'params',
              ext_scale: float = 0.001):
    """Per-frame SMPL -> (betas, kp3d, bones, skts, rest_pose).

    Rest pose comes from rest_pose_from_betas (precomputed joint tables,
    $ANERF_SMPL_TABLES, else smplx + model_path — reference load_zju.py
    get_smpls)."""
    from .process_spin import rest_pose_from_betas

    betas_list, kp3d, bones = [], [], []
    for kp_id in kp_ids:
        params = np.load(os.path.join(subject_path, param_dir,
                                      f'{int(kp_id)}.npy'),
                         allow_pickle=True).item()
        betas_list.append(np.asarray(params['shapes']).reshape(-1))
        poses = np.asarray(params['poses']).reshape(-1, 3)
        Rh = np.asarray(params['Rh']).reshape(3)
        Th = np.asarray(params['Th']).reshape(3)
        from scipy.spatial.transform import Rotation
        # global orientation composed with the zju->nerf rotation
        root = Rotation.from_matrix(
            ZJU_TO_NERF_ROT @ Rotation.from_rotvec(Rh).as_matrix()
            @ Rotation.from_rotvec(poses[0]).as_matrix()).as_rotvec()
        pose = poses.copy()
        pose[0] = root
        bones.append(pose)
        kp3d.append(ZJU_TO_NERF_ROT @ Th)
    betas = np.stack(betas_list).astype(np.float32)
    rest_pose = rest_pose_from_betas(betas, model_path=model_path).astype(
        np.float32)

    bones = np.stack(bones).astype(np.float32)
    pelvis = np.stack(kp3d).astype(np.float32)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose) for b in bones])
    l2ws[..., :3, -1] += pelvis[:, None]
    kp3d = l2ws[..., :3, -1].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    return betas, kp3d, bones, skts, rest_pose


def process_zju_data(data_path: str, subject: str = '377',
                     split: str = 'train', training_view=(0, 6, 12, 18),
                     res: Optional[float] = None, i_intv: int = 1,
                     begin_ith_frame: int = 0,
                     smpl_path: str = 'smpl', param_dir: str = 'params',
                     ext_scale: float = 0.001) -> str:
    """NeuralBody subject dir -> canonical h5 (load_zju.py:400-534)."""
    import cv2
    import imageio.v2 as imageio

    subject_path = os.path.join(data_path, 'zju_mocap', f'CoreView_{subject}')
    annots = np.load(os.path.join(subject_path, 'annots.npy'),
                     allow_pickle=True).item()
    cams = annots['cams']
    num_cams = len(cams['K'])

    n_frames = NUM_TRAIN_FRAMES.get(subject, 300)
    if split == 'train':
        view = np.array(training_view)
        i0, ni = begin_ith_frame, n_frames
    else:
        view = np.array([i for i in range(num_cams)
                         if i not in training_view]) or np.array([0])
        i0, ni = begin_ith_frame + n_frames * i_intv, 100

    frames = annots['ims'][i0:i0 + ni * i_intv][::i_intv]
    img_paths = np.array([np.array(f['ims'])[view] for f in frames]).ravel()
    cam_idxs = np.array([np.arange(len(f['ims']))[view]
                         for f in frames]).ravel()

    probe = imageio.imread(os.path.join(subject_path, img_paths[0]))
    H, W = probe.shape[:2]
    if res:
        H, W = int(H * res), int(W * res)

    imgs = np.zeros((len(img_paths), H, W, 3), np.uint8)
    masks = np.zeros((len(img_paths), H, W, 1), np.uint8)
    sampling_masks = np.zeros((len(img_paths), H, W, 1), np.uint8)
    kp_ids = []
    for i, (img_path, cam_idx) in enumerate(zip(img_paths, cam_idxs)):
        K = np.array(cams['K'][cam_idx])
        D = np.array(cams['D'][cam_idx])
        img = imageio.imread(os.path.join(subject_path, img_path))
        mask = read_mask(subject_path, img_path)
        sampling = dilate_masks(mask[None], iterations=3)[0]

        img = cv2.undistort(img, K, D)
        mask = cv2.undistort(mask, K, D)
        sampling = cv2.undistort(sampling, K, D)
        if res:
            img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (W, H), interpolation=cv2.INTER_NEAREST)
            sampling = cv2.resize(sampling, (W, H),
                                  interpolation=cv2.INTER_NEAREST)
        imgs[i] = img
        masks[i] = (mask > 0).astype(np.uint8)[..., None]
        sampling_masks[i] = (sampling > 0).astype(np.uint8)[..., None]
        kp_ids.append(int(os.path.basename(img_path)[:-4]))

    kp_ids_u, kp_idxs = np.unique(kp_ids, return_inverse=True)
    bkgds = median_backgrounds(imgs, masks, cam_idxs, num_cams)

    c2ws, focals, centers = [], [], []
    for c in range(num_cams):
        R = np.array(cams['R'][c])
        T = np.array(cams['T'][c]) / 1000.0
        K = np.array(cams['K'][c])
        ext = np.concatenate([np.concatenate([R, T], -1),
                              np.array([[0, 0, 0, 1.]])], 0)
        c2w = np.linalg.inv(ext)
        c2w[:3, -1:] = ZJU_TO_NERF_ROT @ c2w[:3, -1:]
        c2w[:3, :3] = ZJU_TO_NERF_ROT @ c2w[:3, :3]
        c2ws.append(c2w)
        if res:
            K = K.copy()
            K[:2] *= res
        focals.append([K[0, 0], K[1, 1]])
        centers.append(K[:2, -1])
    c2ws = swap_mat(np.array(c2ws, np.float32))

    betas, kp3d, bones, skts, rest_pose = get_smpls(
        subject_path, kp_ids_u,
        model_path=os.path.join(data_path, smpl_path), param_dir=param_dir)
    cyls = get_kp_bounding_cylinder(
        kp3d, ext_scale=ext_scale, skel=SMPLSkeleton, extend_mm=250,
        top_expand_ratio=1.00, bot_expand_ratio=0.25, head='-y')

    data = {
        'imgs': imgs, 'bkgds': bkgds, 'bkgd_idxs': cam_idxs.astype(np.int64),
        'masks': masks, 'sampling_masks': sampling_masks,
        'c2ws': c2ws.astype(np.float32),
        'img_pose_indices': cam_idxs.astype(np.int64),
        'kp_idxs': kp_idxs.astype(np.int64),
        'centers': np.array(centers, np.float32),
        'focals': np.array(focals, np.float32),
        'kp3d': kp3d, 'betas': betas.astype(np.float32),
        'bones': bones, 'skts': skts,
        'cyls': cyls.astype(np.float32),
        'rest_pose': rest_pose,
    }
    out = os.path.join(data_path, 'zju_mocap', f'{subject}_{split}_h5py.h5')
    write_h5(out, data)
    return out
