"""The flagship SURREAL model at full width with random weights, on a
synthetic skeleton: the setup of chip_smoke.py and of the kernel_bench
tool (`flagship`), the throughput bench's setup (`_flagship` and
`_batch`, the counterparts of __graft_entry__._flagship and _batch); and
the overrides that make it configs/surreal/surreal_single.txt's
network."""
from __future__ import annotations

import numpy as np
import torch

from ..config import TrainConfig
from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import fk
from ..render.factory import build_render_config, init_render_params
from ..skeleton import SMPLSkeleton, smpl_rest_pose

#: configs/surreal/surreal_single.txt over the flagship (the port reads no
#: config files yet): one network for the coarse and the fine samples,
#: no view PE bands (multires_views 0: 72 + 16 view inputs), 96 + 48
#: samples. Width 256, multires 7, framecodes, N_rand 2048 and
#: raw_noise_std 1 are the flagship's already.
SURREAL_SINGLE = dict(single_net=True, multires_views=0, N_samples=96,
                      N_importance=48)


def _skeleton(n_frames: int):
    """The synthetic skeleton of `n_frames` frames: rest * 0.3, bones and
    pelvis from default_rng(0), through the port's FK. Returns (rest,
    bones, pelvis, kp3d, skts) as numpy arrays."""
    rng = np.random.default_rng(0)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.2).astype(np.float32)
    kp3d, skts, _, _ = fk(torch.as_tensor(bones), torch.as_tensor(rest),
                          torch.as_tensor(pelvis))
    return rest, bones, pelvis, kp3d.numpy(), skts.numpy()


def flagship(n_frames: int, device='cuda', lift_density: bool = True,
             **overrides):
    """__graft_entry__._flagship()'s TrainConfig with the fused kernel on
    (and `overrides` from configs/surreal/surreal.txt; fused_kernel=False
    turns it off), its synthetic skeleton of `n_frames` frames
    (`_skeleton`), and random weights from a seeded generator, with the
    density head's bias lifted by 2 so that the body shows up in renders
    (`lift_density=False` keeps the initial bias). Returns (args, cfg,
    params, rest, bones, kp3d, skts), the skeleton as numpy arrays."""
    args = TrainConfig(**{**dict(
        netdepth=8, netwidth=256, multires=7, multires_views=4,
        N_samples=64, N_importance=16, N_rand=256, N_sample_images=4,
        use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
        cutoff_inputs=True, use_background=True, opt_framecode=True,
        ext_scale=0.001, raw_noise_std=1.0, compute_dtype='bfloat16',
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01, lrate_decay=500, fused_kernel=True), **overrides})
    rest, bones, _, kp3d, skts = _skeleton(n_frames)

    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': n_frames})
    params = init_render_params(args, cfg, torch.Generator().manual_seed(0),
                                device=device)
    # random weights put almost no density anywhere; lift the density
    # head's bias (as tests/test_mesh_render.py does) so the body shows up
    # in the images and the output checks are not vacuous
    if lift_density:
        for net in ('coarse', 'fine'):
            if params[net] is not None:      # no fine net with single_net
                params[net]['alpha_linear']['b'] += 2.0
    return args, cfg, params, rest, bones, kp3d, skts


def _flagship(n_frames: int = 8, n_rays: int = 256, n_images: int = 4,
              compute_dtype: str = 'bfloat16', device='cuda', **overrides):
    """__graft_entry__._flagship: the SURREAL-recipe flagship
    (configs/surreal/surreal.txt) on the synthetic skeleton as the JAX
    bench builds it, the fused kernel off and the density bias as
    initialised. `overrides` of the TrainConfig (fused_kernel=True,
    cull_ratio, small widths) apply before the model is built, as
    bench.py's build re-initialises it after its overrides. Returns
    (args, cfg, params, pose), pose the numpy tables {'rest_pose',
    'bones', 'pelvis', 'kp3d', 'skts', 'cyls'}."""
    args, cfg, params, rest, bones, kp3d, skts = flagship(
        n_frames, device=device, lift_density=False, **{
            **dict(N_rand=n_rays, N_sample_images=n_images,
                   compute_dtype=compute_dtype, fused_kernel=False),
            **overrides})
    pelvis = _skeleton(n_frames)[2]
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=0.001, head='y')
    pose = {'rest_pose': rest, 'bones': bones, 'pelvis': pelvis,
            'kp3d': kp3d, 'skts': skts, 'cyls': np.asarray(cyls, np.float32)}
    return args, cfg, params, pose


def _batch(pose, n_rays: int, n_images: int) -> dict:
    """__graft_entry__._batch: one training batch of numpy arrays aimed at
    the roots of `n_images` frames, drawn from default_rng(1) with the
    same draws in the same order, so that its arrays equal JAX's bit for
    bit (int32 indices, float32 values). Every call starts the generator
    afresh, so every call returns the same batch."""
    rng = np.random.default_rng(1)
    n_frames = pose['kp3d'].shape[0]
    kp_idxs = rng.choice(n_frames, size=n_images, replace=False).astype(
        np.int32)
    pose_idx = np.repeat(np.arange(n_images, dtype=np.int32),
                         n_rays // n_images)
    roots = pose['kp3d'][kp_idxs][:, 0]
    rays_o = (roots + np.array([0., 0.2, 2.5], np.float32))[pose_idx]
    targets = roots[pose_idx] + rng.normal(
        size=(n_rays, 3)).astype(np.float32) * 0.3
    rays_d = targets - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays = np.concatenate(
        [rays_o, rays_d, np.zeros((n_rays, 1), np.float32),
         np.ones((n_rays, 1), np.float32), viewdirs], -1)
    return {
        'rays': rays,
        'target_s': rng.uniform(size=(n_rays, 3)).astype(np.float32),
        'fgs': np.ones((n_rays, 1), np.float32),
        'bgs': np.ones((n_rays, 3), np.float32),
        'cam_idxs': kp_idxs[pose_idx],
        'pose_idx': pose_idx,
        'kp_idxs': kp_idxs,
        'kp3d': pose['kp3d'][kp_idxs],
        'bones': pose['bones'][kp_idxs],
        'skts': pose['skts'][kp_idxs],
        'cyls': pose['cyls'][kp_idxs],
    }
