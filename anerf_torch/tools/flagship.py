"""The flagship SURREAL model at full width with random weights, on a
synthetic skeleton: the setup of chip_smoke.py and of the kernel_bench
tool (the port's counterpart of __graft_entry__._flagship); and the
overrides that make it configs/surreal/surreal_single.txt's network."""
from __future__ import annotations

import numpy as np
import torch

from ..config import TrainConfig
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


def flagship(n_frames: int, device='cuda', **overrides):
    """__graft_entry__._flagship()'s TrainConfig with the fused kernel on
    (and `overrides` from configs/surreal/surreal.txt), its synthetic
    skeleton of `n_frames` frames (rest * 0.3, bones / pelvis from
    default_rng(0)) through the port's FK, and random weights from a
    seeded generator, with the density head's bias lifted by 2 so that
    the body shows up in renders. Returns (args, cfg, params, rest,
    bones, kp3d, skts), the skeleton as numpy arrays."""
    args = TrainConfig(**{**dict(
        netdepth=8, netwidth=256, multires=7, multires_views=4,
        N_samples=64, N_importance=16, N_rand=256, N_sample_images=4,
        use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
        cutoff_inputs=True, use_background=True, opt_framecode=True,
        ext_scale=0.001, raw_noise_std=1.0, compute_dtype='bfloat16',
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01, lrate_decay=500, fused_kernel=True), **overrides})
    rng = np.random.default_rng(0)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.2).astype(np.float32)
    kp3d, skts, _, _ = fk(torch.as_tensor(bones), torch.as_tensor(rest),
                          torch.as_tensor(pelvis))

    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': n_frames})
    params = init_render_params(args, cfg, torch.Generator().manual_seed(0),
                                device=device)
    # random weights put almost no density anywhere; lift the density
    # head's bias (as tests/test_mesh_render.py does) so the body shows up
    # in the images and the output checks are not vacuous
    for net in ('coarse', 'fine'):
        if params[net] is not None:          # no fine net with single_net
            params[net]['alpha_linear']['b'] += 2.0
    return args, cfg, params, rest, bones, kp3d.numpy(), skts.numpy()
