"""Assemble RenderConfig + parameters from a TrainConfig (torch port of
anerf_tpu/render/factory.py)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..config import TrainConfig
from ..kernels.fused_render import fused_render_supported
from ..models.nerf import NeRFConfig, init_nerf_params
from ..ops.embedder import EmbedConfig, make_embedder
from ..ops.encoding import (make_bone_encoder, make_kp_encoder,
                            make_view_encoder)
from ..skeleton import Skeleton, SMPLSkeleton
from .raycaster import RenderConfig


def build_render_config(args: TrainConfig, data_attrs: Dict[str, Any]
                        ) -> RenderConfig:
    """The encoder/embedder/MLP wiring of the JAX factory, field for
    field, so both packages build the same configuration."""
    skel: Skeleton = data_attrs.get('skel_type', SMPLSkeleton)
    n_framecodes = (data_attrs['n_views'] if args.n_framecodes is None
                    else args.n_framecodes)

    _, input_dims, cutoff_dims = make_kp_encoder(args.kp_dist_type, skel)
    _, bone_dims = make_bone_encoder(args.bone_type, skel)
    _, view_dims = make_view_encoder(args.view_type, skel)

    cutoff_kwargs = {
        'cutoff': args.use_cutoff,
        'normalize_cutoff': args.normalize_cutoff,
        'cutoff_inputs': args.cutoff_inputs,
        'cutoff_dim': cutoff_dims,
        'dist_inputs': not (input_dims == cutoff_dims),
        'freq_schedule': args.freq_schedule,
        'init_alpha': args.init_freq,
    }

    kp_kwargs = dict(cutoff_kwargs)
    kp_kwargs['cut_to_cutoff'] = args.cut_to_dist
    kp_kwargs['shift_inputs'] = args.cutoff_shift
    embed_kp, input_ch = make_embedder(args.multires, input_dims,
                                       args.i_embed, kp_kwargs)

    embed_bone: Optional[EmbedConfig] = None
    input_ch_bones = bone_dims
    if bone_dims > 0:
        if args.cutoff_bones:
            bone_kwargs = dict(cutoff_kwargs)
            bone_kwargs['dist_inputs'] = True
        else:
            bone_kwargs = {'cutoff': False}
        embed_bone, input_ch_bones = make_embedder(
            args.multires_bones, bone_dims, args.i_embed, bone_kwargs)

    embed_view: Optional[EmbedConfig] = None
    input_ch_views = 0
    if args.use_viewdirs:
        if args.cutoff_viewdir:
            view_kwargs = dict(cutoff_kwargs)
            view_kwargs['dist_inputs'] = True
        else:
            view_kwargs = {'cutoff': False}
        view_kwargs['cutoff_dim'] = skel.n_joints
        embed_view, input_ch_views = make_embedder(
            args.multires_views, view_dims, args.i_embed, view_kwargs)

    nerf_cfg = NeRFConfig(
        depth=args.netdepth, width=args.netwidth,
        input_ch=input_ch, input_ch_bones=input_ch_bones,
        input_ch_views=input_ch_views,
        output_ch=5 if args.N_importance > 0 else 4,
        skips=(4,), use_viewdirs=args.use_viewdirs,
        use_framecode=args.opt_framecode,
        framecode_ch=args.framecode_size,
        n_framecodes=int(n_framecodes),
        density_scale=args.density_scale)

    cfg = RenderConfig(
        nerf=nerf_cfg, embed_kp=embed_kp, embed_bone=embed_bone,
        embed_view=embed_view, skel=skel,
        kp_dist_type=args.kp_dist_type, bone_type=args.bone_type,
        view_type=args.view_type,
        n_samples=args.N_samples, n_importance=args.N_importance,
        perturb=args.perturb, raw_noise_std=args.raw_noise_std,
        ray_noise_std=args.ray_noise_std, lindisp=args.lindisp,
        single_net=args.single_net, use_viewdirs=args.use_viewdirs,
        density_type=args.density_type, softplus_shift=args.softplus_shift,
        density_scale=args.density_scale,
        compute_dtype=args.compute_dtype, fast_grads=args.fast_grads,
        fast_pe=args.fast_pe, fast_mlp=args.fast_mlp,
        alpha_f32=args.alpha_f32, hifi_pe=args.hifi_pe,
        remat_pe=args.remat_pe, sr_grads=args.sr_grads,
        n_keep=_n_keep(args, skel), cull_margin=args.cull_margin,
        use_fused=args.fused_kernel)
    if cfg.use_fused:
        if not fused_render_supported(cfg):
            raise NotImplementedError(
                '--fused_kernel requires the standard encoder family '
                '(reldist/reldir/relray, cutoff_inputs, no freq_schedule; '
                'see kernels/fused_render.py:fused_render_supported)')
        if cfg.dtype is None:
            raise NotImplementedError(
                '--fused_kernel requires --compute_dtype bfloat16')
    return cfg


def _n_keep(args: TrainConfig, skel: Skeleton) -> int:
    """Static per-ray sample budget from --cull_ratio (0 = culling off)."""
    if args.cull_ratio <= 0.0 or args.cull_ratio >= 1.0:
        return 0
    _, input_dims, cutoff_dims = make_kp_encoder(args.kp_dist_type, skel)
    if cutoff_dims != skel.n_joints:
        raise NotImplementedError(
            '--cull_ratio requires a per-joint cutoff encoder')
    keep = int(round(args.N_samples * args.cull_ratio / 8.0)) * 8
    return max(8, min(keep, args.N_samples))


def init_render_params(args: TrainConfig, cfg: RenderConfig,
                       generator: torch.Generator,
                       device='cuda') -> Dict[str, Any]:
    """Initialize {'coarse', 'fine', 'cutoff_dist'} from `generator` on
    `device` (the GPU unless the caller passes 'cpu')."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        'coarse': init_nerf_params(cfg.nerf, generator, dev),
        'fine': None,
        'cutoff_dist': torch.full((cfg.embed_kp.cutoff_dim,),
                                  args.cutoff_mm * args.ext_scale,
                                  dtype=torch.float32, device=dev),
    }
    if cfg.n_importance > 0 and not cfg.single_net:
        params['fine'] = init_nerf_params(cfg.nerf, generator, dev)
    return params
