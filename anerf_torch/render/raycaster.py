"""The rendering core: cylinder bounds -> sampling -> skeleton-relative
encoding -> MLP -> compositing -> importance resampling -> fine pass
(torch port of anerf_tpu/render/raycaster.py).

Two branches compute the encoding + MLP, as in the JAX package:
`use_fused` runs the fused kernels (kernels/fused_render.py) twice per
call, once for the coarse net at S = n_samples and once for the fine net
on the [coarse ++ importance] concatenation: through `fused_apply` (K1
forward, K2 backward) when training, or K1 alone on operands the caller
packed once (`packed`, the render path). Otherwise plain torch mirrors
the JAX XLA path (encode_inputs + run_network) and autograd gives its
backward. Randomness draws from an explicit torch.Generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..kernels.fused_render import (fused_apply, fused_encode_mlp_pts,
                                    pack_ray_data, pack_render_params)
from ..models.nerf import NeRFConfig, apply_nerf, lookup_framecodes
from ..ops.compositing import get_density_fn, raw2outputs
from ..ops.cylinder import get_near_far_in_cylinder
from ..ops.embedder import EmbedConfig, embed
from ..ops.encoding import (_expand3, _group3_sumsq, make_bone_encoder,
                            rot_cols, rotate_flat, transform_batch_pts_flat)
from ..ops.sampling import (isample_from_lineseg, sample_from_lineseg,
                            scatter_rows)
from ..skeleton import Skeleton, SMPLSkeleton


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the render path (the JAX package's fields,
    so both packages build it from the same TrainConfig)."""
    nerf: NeRFConfig
    embed_kp: EmbedConfig
    embed_bone: Optional[EmbedConfig]
    embed_view: Optional[EmbedConfig]
    skel: Skeleton = SMPLSkeleton
    kp_dist_type: str = 'reldist'
    bone_type: str = 'reldir'
    view_type: str = 'relray'
    n_samples: int = 64
    n_importance: int = 16
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    ray_noise_std: float = 0.0
    lindisp: bool = False
    single_net: bool = False
    use_viewdirs: bool = True
    density_type: str = 'relu'
    softplus_shift: float = 1.0
    density_scale: float = 1.0
    rgb_eps: float = 0.001
    compute_dtype: str = 'bfloat16'
    fast_grads: bool = False
    fast_pe: Optional[bool] = None
    fast_mlp: Optional[bool] = None
    alpha_f32: bool = False
    sr_grads: bool = False
    hifi_pe: bool = False
    remat_pe: bool = False
    n_keep: int = 0
    cull_margin: float = 0.1
    use_fused: bool = False

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == 'bfloat16' else None

    @property
    def eff_fast_pe(self) -> bool:
        return self.fast_grads if self.fast_pe is None else self.fast_pe

    @property
    def eff_fast_mlp(self) -> bool:
        return self.fast_grads if self.fast_mlp is None else self.fast_mlp

    def test_mode(self) -> 'RenderConfig':
        """Copy with stochasticity disabled."""
        return dataclasses.replace(self, perturb=0.0, raw_noise_std=0.0,
                                   ray_noise_std=0.0)


def encode_inputs(cfg: RenderConfig, pts: torch.Tensor,
                  rays_d: torch.Tensor, skts: torch.Tensor,
                  cutoff_dist: torch.Tensor, tau
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """Skeleton-relative encoding of query points on the flat joint-major
    path: pts (R, S, 3), rays_d (R, 1, 3), skts (R, J, 4, 4).
    Returns {'v', 'r', 'd'} embedded features in the compute dtype."""
    if not (cfg.kp_dist_type == 'reldist'
            and cfg.bone_type in ('reldir', 'Nope')
            and cfg.view_type == 'relray'):
        raise NotImplementedError(
            'anerf_torch encode_inputs: only the reldist/reldir/relray '
            'encoder family is ported yet')
    if cfg.eff_fast_pe:
        raise NotImplementedError('fast_pe (bf16 PE emission) is not '
                                  'ported yet')
    J = cfg.skel.n_joints
    _, bone_dims = make_bone_encoder(cfg.bone_type, cfg.skel)
    pts_tf = transform_batch_pts_flat(pts, skts)              # (R, S, J*3)
    v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_tf, J), 0.0))
    r = None
    if bone_dims > 0:
        r = pts_tf * _expand3(1.0 / torch.clamp_min(v, 1e-12), J)
    rays_f = rotate_flat(rays_d, rot_cols(skts))              # (R, 1, J*3)
    dss = _group3_sumsq(rays_f, J)
    d = rays_f * _expand3(torch.rsqrt(torch.clamp_min(dss, 1e-24)), J)

    enc_dtype = cfg.dtype or torch.float32
    v_e, _ = embed(cfg.embed_kp, v, dists=v, cutoff_dist=cutoff_dist,
                   tau=tau)
    r_e = None
    if r is not None and cfg.embed_bone is not None:
        r_e, _ = embed(cfg.embed_bone, r, dists=v, cutoff_dist=cutoff_dist,
                       tau=tau)
        r_e = r_e.to(enc_dtype)
    d_e = None
    if cfg.use_viewdirs and cfg.embed_view is not None:
        d_e, _ = embed(cfg.embed_view, d, dists=v, cutoff_dist=cutoff_dist,
                       tau=tau)
        d_e = d_e.to(enc_dtype).expand(pts.shape[0], pts.shape[1],
                                       d_e.shape[-1])
    return {'v': v_e.to(enc_dtype), 'r': r_e, 'd': d_e}


def run_network(cfg: RenderConfig, params: Dict[str, Any],
                encoded: Dict[str, Optional[torch.Tensor]],
                framecodes: Optional[torch.Tensor]) -> torch.Tensor:
    """Concatenate encodings and apply the MLP over all (R, S) points."""
    parts = [encoded['v']]
    if encoded['r'] is not None:
        parts.append(encoded['r'])
    pts_in = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
    fc = None
    if framecodes is not None:
        fc = framecodes[:, None].expand(pts_in.shape[0], pts_in.shape[1],
                                        framecodes.shape[-1])
    return apply_nerf(params, cfg.nerf, pts_in, encoded['d'], fc,
                      compute_dtype=cfg.dtype)


def pack_fused_params(params: Dict[str, Any], cfg: RenderConfig
                      ) -> Dict[str, Any]:
    """Kernel operands for the coarse (and fine) net, packed once so a
    caller that renders many ray batches with the same weights can pass
    them to render_rays."""
    args = (cfg.nerf, cfg.embed_kp.num_freqs, cfg.embed_view.num_freqs,
            params['cutoff_dist'])
    packed = {'coarse': pack_render_params(params['coarse'], *args),
              'fine': None}
    if cfg.n_importance > 0 and not cfg.single_net:
        packed['fine'] = pack_render_params(params['fine'], *args)
    return packed


def _sample_pts(rays_o, rays_d, z_vals, ray_noise_std, generator):
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    if ray_noise_std > 0.0:
        pts = pts + torch.randn(pts.shape, generator=generator,
                                dtype=pts.dtype,
                                device=pts.device) * ray_noise_std
    return pts


def render_rays(params: Dict[str, Any], cfg: RenderConfig,
                ray_batch: torch.Tensor, kp_batch: torch.Tensor,
                skts: torch.Tensor, bones: Optional[torch.Tensor],
                cyls: torch.Tensor,
                cam_idxs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                tau=2000.0,
                eval_framecode_mean: bool = False,
                packed: Optional[Dict[str, Any]] = None,
                ) -> Dict[str, torch.Tensor]:
    """Volumetric rendering of a packed ray batch (R, 8|11) =
    [o, d, near, far, (viewdirs)]. params: {'coarse', 'fine',
    'cutoff_dist'}. `packed` (from pack_fused_params) makes the fused
    branch run K1 alone on those operands (no gradient: the render path);
    without it the fused branch goes through fused_apply, whose backward
    is K2. Returns rgb_map / disp_map /
    acc_map / alpha (+ the coarse rgb0 / disp0 / acc0 / alpha0).
    kp_batch and bones are accepted for the JAX signature; the ported
    (reldist) encoders do not read them."""
    if cfg.n_keep and cfg.n_keep < cfg.n_samples:
        raise NotImplementedError('sample culling (cull_ratio) is not '
                                  'ported yet')
    if generator is None and (cfg.perturb > 0.0 or cfg.raw_noise_std > 0.0
                              or cfg.ray_noise_std > 0.0):
        raise ValueError('a stochastic RenderConfig needs a generator; '
                         'use cfg.test_mode() for deterministic renders')

    rays_o, rays_d = ray_batch[:, 0:3], ray_batch[:, 3:6]
    near, far = get_near_far_in_cylinder(rays_o, rays_d, cyls,
                                         near=ray_batch[:, 6:7],
                                         far=ray_batch[:, 7:8])
    z_vals = sample_from_lineseg(near, far, cfg.n_samples, cfg.perturb,
                                 cfg.lindisp, generator=generator)
    pts = _sample_pts(rays_o, rays_d, z_vals, cfg.ray_noise_std, generator)

    cutoff_dist = params['cutoff_dist']
    act_fn = get_density_fn(cfg.density_type, cfg.softplus_shift)

    framecodes = None
    if cfg.nerf.use_framecode:
        if cam_idxs is None:
            cam_idxs = torch.zeros((rays_o.shape[0],), dtype=torch.long,
                                   device=rays_o.device)
            eval_framecode_mean = True
        framecodes = lookup_framecodes(params['coarse'], cam_idxs,
                                       eval_mean=eval_framecode_mean)

    if cfg.use_fused:
        if packed is None and cfg.eff_fast_mlp and torch.is_grad_enabled():
            raise NotImplementedError(
                'the fused backward with bf16 cotangents (fast_grads / '
                'fast_mlp) is not ported yet; K2 runs f32 cotangents only')
        nf = (cfg.embed_kp.num_freqs, cfg.embed_view.num_freqs)

        def net(name, pts_in, aux_in):
            if packed is not None:
                return fused_encode_mlp_pts(cfg.nerf, packed[name], pts_in,
                                            m_all, aux_in, pts_in.shape[1],
                                            tau)
            return fused_apply(cfg.nerf, pts_in.shape[1], params[name],
                               cutoff_dist, *nf, pts_in, m_all, aux_in, tau)
        m_all, aux = pack_ray_data(rays_d[:, None, :], skts, framecodes)
        raw = net('coarse', pts, aux)
    else:
        encoded = encode_inputs(cfg, pts, rays_d[:, None, :], skts,
                                cutoff_dist, tau)
        raw = run_network(cfg, params['coarse'], encoded, framecodes)
    ret = raw2outputs(raw, z_vals, rays_d, cfg.raw_noise_std, generator,
                      cfg.density_scale, act_fn, cfg.rgb_eps)

    ret0 = None
    if cfg.n_importance > 0:
        ret0 = ret
        z_all, z_samples, merge_ranks = isample_from_lineseg(
            z_vals, ret0['weights'], cfg.n_importance,
            det=(cfg.perturb == 0.0), is_only=cfg.single_net,
            generator=generator)
        pts_is = _sample_pts(rays_o, rays_d, z_samples, cfg.ray_noise_std,
                             generator)

        fine_params = params['coarse'] if cfg.single_net else params['fine']
        fc_fine = framecodes
        if cfg.nerf.use_framecode and not cfg.single_net:
            fc_fine = lookup_framecodes(params['fine'], cam_idxs,
                                        eval_mean=eval_framecode_mean)

        # the MLP is pointwise: run it on the unsorted [coarse ++ new]
        # concatenation and reorder only the raw outputs by merge rank
        if cfg.use_fused:
            if not cfg.single_net:
                _, aux_f = pack_ray_data(rays_d[:, None, :], skts, fc_fine)
                raw_all = net('fine', torch.cat([pts, pts_is], 1), aux_f)
            else:
                raw_all = torch.cat([raw, net('coarse', pts_is, aux)], 1)
        elif not cfg.single_net:
            encoded_is = encode_inputs(cfg, pts_is, rays_d[:, None, :],
                                       skts, cutoff_dist, tau)
            cat_enc = {k: torch.cat([encoded[k], encoded_is[k]], 1)
                       if encoded[k] is not None else None
                       for k in encoded}
            raw_all = run_network(cfg, fine_params, cat_enc, fc_fine)
        else:
            encoded_is = encode_inputs(cfg, pts_is, rays_d[:, None, :],
                                       skts, cutoff_dist, tau)
            raw_is = run_network(cfg, fine_params, encoded_is, fc_fine)
            raw_all = torch.cat([raw, raw_is], 1)
        raw_fine = scatter_rows(raw_all, merge_ranks)
        ret = raw2outputs(raw_fine, z_all, rays_d, cfg.raw_noise_std,
                          generator, cfg.density_scale, act_fn, cfg.rgb_eps)

    out = {'rgb_map': ret['rgb_map'], 'disp_map': ret['disp_map'],
           'acc_map': ret['acc_map'], 'alpha': ret['alpha']}
    if ret0 is not None:
        out.update({'rgb0': ret0['rgb_map'], 'disp0': ret0['disp_map'],
                    'acc0': ret0['acc_map'], 'alpha0': ret0['alpha']})
    return out
