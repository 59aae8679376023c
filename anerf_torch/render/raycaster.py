"""The rendering core: cylinder bounds -> sampling -> skeleton-relative
encoding -> MLP -> compositing -> importance resampling -> fine pass
(torch port of anerf_tpu/render/raycaster.py).

Two branches compute the encoding + MLP, as in the JAX package:
`use_fused` runs the fused kernels (kernels/fused_render.py) twice per
call, once for the coarse net at S = n_samples and once for the fine net
on the [coarse ++ importance] concatenation: through `fused_apply` (K1
forward, K2 backward) when training, or K1 alone on operands the caller
packed once (`packed`, the render path). K2's cotangent products are f32
unless the MLP fast-grads knob is on (`eff_fast_mlp`: bf16 operands, as
the JAX package's `bwd_f32=False`). Otherwise plain torch mirrors the
JAX XLA path (encode_inputs + run_network) with every encoder kind and
embedder mode, and autograd gives its backward, through the JAX
package's custom backwards where its numerics knobs ask for them
(fast_pe / hifi_pe / remat_pe in ops/embedder.py; fast_mlp / alpha_f32
/ sr_grads in models/nerf.py). With `n_keep` < n_samples,
`cull_samples` keeps a fixed budget of samples per ray before either
branch. Randomness draws from an explicit torch.Generator, the SR keys
of --sr_grads too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.fused_render import (fused_apply, fused_encode_mlp_pts,
                                    pack_ray_data, pack_render_params)
from ..models.nerf import (NeRFConfig, _dense, apply_nerf, forward_density,
                           lookup_framecodes, sr_salt)
from ..ops.compositing import get_density_fn, raw2outputs
from ..ops.cylinder import get_near_far_in_cylinder
from ..ops.embedder import EmbedConfig, embed
from ..ops.encoding import (_expand3, _group3_sumsq, _norm, make_bone_encoder,
                            make_kp_encoder, make_view_encoder, rot_cols,
                            rotate_flat, transform_batch_pts,
                            transform_batch_pts_flat, transform_batch_rays)
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
                  rays_d: torch.Tensor, kps: torch.Tensor,
                  skts: torch.Tensor, bones: Optional[torch.Tensor],
                  cutoff_dist: torch.Tensor, tau, alpha_sched=None,
                  views: bool = True
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """Skeleton-relative encoding of query points: pts (R, S, 3), rays_d
    (R, 1, 3), kps (R, J, 3), skts (R, J, 4, 4), bones (R, J, 3) (read by
    'axisang' only). The reldist / reldir|Nope / relray family takes the
    flat joint-major path, every other the (R, S, J, 3) one. alpha_sched
    is the frequency schedule's value (None at render time). Returns
    {'v', 'r', 'd'} embedded features in the compute dtype; 'd' is None
    with views=False (a density query, which never reads it).

    'world' gets the world-frame ray direction: the JAX package hands it
    the per-joint rays, 24 times the width its spec declares, and fails
    in the MLP's first view layer."""
    kp_spec, _, _ = make_kp_encoder(cfg.kp_dist_type, cfg.skel)
    bone_spec, bone_dims = make_bone_encoder(cfg.bone_type, cfg.skel)
    view_spec, _ = make_view_encoder(cfg.view_type, cfg.skel)
    views = views and cfg.use_viewdirs and cfg.embed_view is not None
    J = cfg.skel.n_joints
    r = d = None
    if (cfg.kp_dist_type == 'reldist' and cfg.bone_type in ('reldir', 'Nope')
            and cfg.view_type == 'relray'):
        pts_tf = transform_batch_pts_flat(pts, skts)          # (R, S, J*3)
        v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_tf, J), 0.0))
        if bone_dims > 0:
            r = pts_tf * _expand3(1.0 / torch.clamp_min(v, 1e-12), J)
        if views:
            rays_f = rotate_flat(rays_d, rot_cols(skts))      # (R, 1, J*3)
            dss = _group3_sumsq(rays_f, J)
            d = rays_f * _expand3(torch.rsqrt(torch.clamp_min(dss, 1e-24)),
                                  J)
        j_dists = v
    else:
        pts_t = transform_batch_pts(pts, skts)                # (R, S, J, 3)
        v = kp_spec(pts, pts_t, kps)
        if bone_dims > 0:
            r = bone_spec(pts_t, bones=bones, refs=pts)
        if views:
            rays_t = (rays_d if cfg.view_type == 'world'
                      else transform_batch_rays(rays_d, skts))
            d = view_spec(rays_t, pts_t=pts_t,
                          refs=None if cfg.view_type == 'relray' else pts)
        # per-joint distances for the cutoff windows
        j_dists = (v if 'Dist' in kp_spec.name
                   else _norm(pts[:, :, None] - kps[:, None]))

    # PE numerics: bf16 emission and backward with fast_pe; hifi_pe keeps
    # the default forward and lowers only the backward; remat_pe keeps
    # both f32 and recomputes sin / cos in the backward
    dt = cfg.dtype
    pe_dtype = dt if cfg.eff_fast_pe else None
    hifi = cfg.hifi_pe and dt is not None
    remat = cfg.remat_pe and dt is not None and pe_dtype is None and not hifi
    pe_kw = dict(dists=j_dists, cutoff_dist=cutoff_dist, tau=tau,
                 alpha=alpha_sched, out_dtype=pe_dtype,
                 hifi_dtype=dt if hifi else None,
                 remat_dtype=dt if remat else None)
    enc_dtype = dt or torch.float32
    v_e = embed(cfg.embed_kp, v, **pe_kw)[0].to(enc_dtype)
    r_e = d_e = None
    if r is not None and cfg.embed_bone is not None:
        r_e = embed(cfg.embed_bone, r, **pe_kw)[0].to(enc_dtype)
    if d is not None:
        d_e = embed(cfg.embed_view, d, **pe_kw)[0].to(enc_dtype)
        if d_e.shape[1] == 1:
            d_e = d_e.expand(pts.shape[0], pts.shape[1], d_e.shape[-1])
    return {'v': v_e, 'r': r_e, 'd': d_e}


def run_network(cfg: RenderConfig, params: Dict[str, Any],
                encoded: Dict[str, Optional[torch.Tensor]],
                framecodes: Optional[torch.Tensor],
                sr_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate encodings and apply the MLP over all (R, S) points.
    The MLP's cotangents are bf16 with eff_fast_mlp, stochastically
    rounded with sr_grads and a key (which implies fast_grads there, as
    in the JAX package); alpha_f32 keeps the alpha head's f32."""
    parts = [encoded['v']]
    if encoded['r'] is not None:
        parts.append(encoded['r'])
    pts_in = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
    fc = None
    if framecodes is not None:
        fc = framecodes[:, None].expand(pts_in.shape[0], pts_in.shape[1],
                                        framecodes.shape[-1])
    use_sr = cfg.sr_grads and sr_key is not None
    return apply_nerf(params, cfg.nerf, pts_in, encoded['d'], fc,
                      compute_dtype=cfg.dtype,
                      fast_grads=cfg.eff_fast_mlp or use_sr,
                      alpha_f32=cfg.alpha_f32,
                      sr_key=sr_key if use_sr else None)


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


def cull_samples(cfg: RenderConfig, z_vals: torch.Tensor,
                 pts: torch.Tensor, kps: torch.Tensor,
                 cutoff_dist: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget occupancy culling: keep cfg.n_keep samples per ray
    (the JAX package's cull_samples). z_vals (R, S) ascending, pts
    (R, S, 3), kps (R, J, 3) -> (z (R, n_keep), pts (R, n_keep, 3)).

    A sample is in the window when some joint lies within
    cutoff * (1 + cull_margin). Of a ray's c in-window samples, the one
    of rank r (1-based, by z) is kept iff ceil(r K / c) >
    ceil((r - 1) K / c): min(c, K) of them, spread evenly over the span.
    When c < K the nearest samples by z of the rest fill the budget. The
    kept set comes back in ascending z. The JAX package's arithmetic is
    kept where a sample at the window's edge could flip: d2 is the
    expansion |p|^2 - 2 p.k + |k|^2 in true fp32 (no TF32 matmul), the
    ranks are divided in f32, and both sorts are stable. No gradient
    reaches kps: the selection is discrete and the kept z / pts are the
    input's values."""
    K = cfg.n_keep
    with torch.no_grad():
        p, k = pts.detach(), kps.detach()
        sq = lambda x: (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
            + x[..., 2] * x[..., 2]
        pk = ((p[:, :, None, 0] * k[:, None, :, 0]
               + p[:, :, None, 1] * k[:, None, :, 1])
              + p[:, :, None, 2] * k[:, None, :, 2])       # (R, S, J)
        d2 = (sq(p)[..., None] - 2.0 * pk) + sq(k)[:, None]
        cut = cutoff_dist.detach() * (1.0 + cfg.cull_margin)
        in_window = (d2 < (cut * cut)).any(-1)              # (R, S)

        rank = torch.cumsum(in_window.int(), -1, dtype=torch.int32)
        c = torch.clamp_min(rank[:, -1:], 1).float()
        sel_in = in_window & (torch.ceil((rank * K).float() / c)
                              > torch.ceil(((rank - 1) * K).float() / c))
        # selected first, the rest after, each by z: one stable key sort
        span = z_vals[:, -1:] - z_vals[:, :1] + 1e-6
        key = torch.where(sel_in, 0.0, 1.0) * (span * 4.0) + z_vals
        order = torch.sort(key, dim=-1, stable=True).indices[:, :K]
        z_order = torch.sort(torch.gather(z_vals, 1, order), dim=-1,
                             stable=True).indices
        sel = torch.gather(order, 1, z_order)               # (R, K)
    return (torch.gather(z_vals, 1, sel),
            torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3)))


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
                alpha_sched=None,
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
    kp_batch (R, J, 3) is read by `cull_samples` and the encoders that
    need the joints, bones (R, J, 3) by 'axisang'; alpha_sched is the
    frequency schedule's value (None at render time). With sr_grads on
    the plain branch, the coarse and the fine net's SR keys are drawn
    from `generator` (none without it: the deterministic fast path)."""
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

    if cfg.n_keep and cfg.n_keep < cfg.n_samples:
        z_vals, pts = cull_samples(cfg, z_vals, pts, kp_batch, cutoff_dist)

    framecodes = None
    if cfg.nerf.use_framecode:
        if cam_idxs is None:
            cam_idxs = torch.zeros((rays_o.shape[0],), dtype=torch.long,
                                   device=rays_o.device)
            eval_framecode_mean = True
        framecodes = lookup_framecodes(params['coarse'], cam_idxs,
                                       eval_mean=eval_framecode_mean)

    if cfg.use_fused:
        nf = (cfg.embed_kp.num_freqs, cfg.embed_view.num_freqs)
        # K2's cotangent products follow the MLP fast-grads knob, as in
        # the JAX package: f32 without it, bf16 operands with it
        bwd_f32 = not cfg.eff_fast_mlp

        def net(name, pts_in, aux_in):
            if packed is not None:
                return fused_encode_mlp_pts(cfg.nerf, packed[name], pts_in,
                                            m_all, aux_in, pts_in.shape[1],
                                            tau)
            return fused_apply(cfg.nerf, pts_in.shape[1], params[name],
                               cutoff_dist, *nf, pts_in, m_all, aux_in, tau,
                               bwd_f32)
        m_all, aux = pack_ray_data(rays_d[:, None, :], skts, framecodes)
        raw = net('coarse', pts, aux)
    else:
        enc = lambda p: encode_inputs(cfg, p, rays_d[:, None, :], kp_batch,
                                      skts, bones, cutoff_dist, tau,
                                      alpha_sched)
        draw_sr = cfg.sr_grads and generator is not None
        sr_key = lambda: sr_salt(generator) if draw_sr else None
        encoded = enc(pts)
        raw = run_network(cfg, params['coarse'], encoded, framecodes,
                          sr_key())
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
            encoded_is = enc(pts_is)
            cat_enc = {k: torch.cat([encoded[k], encoded_is[k]], 1)
                       if encoded[k] is not None else None
                       for k in encoded}
            raw_all = run_network(cfg, fine_params, cat_enc, fc_fine,
                                  sr_key())
        else:
            raw_is = run_network(cfg, fine_params, enc(pts_is), fc_fine,
                                 sr_key())
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


#: points a density query encodes and runs through the MLP at once: the
#: JAX package evaluates all (res + 1)^3 mesh points in one call, which at
#: res 255 (16.8M points, each encoded against 24 joint frames) would
#: take tens of GB of intermediates
MESH_CHUNK = 1 << 18


@torch.no_grad()
def render_pts_density(params: Dict[str, Any], cfg: RenderConfig,
                       pts: torch.Tensor, kps: torch.Tensor,
                       skts: torch.Tensor, bones: Optional[torch.Tensor],
                       tau=2000.0, use_fine: bool = True,
                       chunk: int = MESH_CHUNK) -> torch.Tensor:
    """Raw density of arbitrary query points (the JAX package's
    render_pts_density; plain torch, as the JAX package computes it on
    the XLA path with no Pallas kernel).

    pts: (R, S, 3) with skts broadcast (R may be 1). Returns (R, S, 1)
    f32. The points go through the encoder and the density trunk `chunk`
    at a time along S."""
    cutoff_dist = params['cutoff_dist']
    net = params['fine'] if (use_fine and params.get('fine') is not None) \
        else params['coarse']
    zeros_d = torch.zeros_like(pts[:, :1])
    outs = []
    for s0 in range(0, pts.shape[1], chunk):
        p = pts[:, s0:s0 + chunk]
        encoded = encode_inputs(cfg, p, zeros_d, kps, skts, bones,
                                cutoff_dist, tau, views=False)
        parts = [encoded['v']]
        if encoded['r'] is not None:
            parts.append(encoded['r'])
        pts_in = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        h = forward_density(net, cfg.nerf, pts_in, cfg.dtype)
        if 'alpha_linear' in net:
            outs.append(_dense(net['alpha_linear'], h, cfg.dtype))
        else:
            # use_viewdirs=False head: density is output_linear's last
            # channel
            outs.append(_dense(net['output_linear'], h, cfg.dtype)[..., 3:4])
    return torch.cat(outs, 1)


def render_mesh_density(params: Dict[str, Any], cfg: RenderConfig,
                        kps: torch.Tensor, skts: torch.Tensor,
                        bones: Optional[torch.Tensor],
                        radius: float = 1.0, res: int = 64, tau=2000.0,
                        chunk: int = MESH_CHUNK) -> torch.Tensor:
    """Density on a res^3 grid centered at the root joint, on the device
    of `kps`. Returns (res+1, res+1, res+1) raw density (f32)."""
    t = torch.linspace(-radius, radius, res + 1, dtype=torch.float32,
                       device=kps.device)
    grid = torch.stack(torch.meshgrid(t, t, t, indexing='xy'), -1)
    sh = grid.shape
    pts = grid.reshape(1, -1, 3) + kps[0:1, 0:1]
    sigma = render_pts_density(params, cfg, pts, kps[:1], skts[:1],
                               None if bones is None else bones[:1], tau,
                               chunk=chunk)
    return sigma.reshape(sh[:-1]).transpose(0, 1)
