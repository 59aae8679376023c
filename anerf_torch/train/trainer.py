"""The train step: render -> losses -> dual optimizer update (torch port of
anerf_tpu/train/trainer.py; reference core/trainer.py:205-483).

One `step(state, batch, generator)` runs pose FK, rendering, the losses,
autograd, and both Adam updates over flat vectors. The step counter is a
host integer, so the pose-interval rules (accumulate pose gradients until
`step % opt_pose_step == 0`, drop them during `opt_pose_warmup`) are
plain Python branches where the JAX package uses masked selects; the
results are the same. With `RenderConfig.use_fused` the MLP runs through
`fused_apply` (K1 forward, K2 backward).

Batch contract (R rays, NI images per batch), torch tensors on the device:
  rays        (R, 11)  packed [o, d, near, far, viewdirs]
  target_s    (R, 3)   ground-truth pixels
  fgs         (R, 1)   foreground mask values
  bgs         (R, 3)   background pixels (or ones)
  cam_idxs    (R,)     camera/frame index per ray (framecodes)
  pose_idx    (R,)     image slot per ray, indexes the per-image tables
  kp_idxs     (NI,)    global frame index per image slot (pose-opt lookup)
  kp3d/bones/skts/cyls (NI, ...) per-image pose tables (non-popt path)
  temp_val    (NI,)    temporal validity (only when use_temp_loss)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..ops.embedder import alpha_schedule, tau_schedule
from ..ops.rotations import rot_to_rot6d
from ..pose.pose_opt import PoseOptConfig, fk_lookup
from ..render.raycaster import RenderConfig, render_rays
from .losses import get_loss_fn, get_reg_fn, img2psnr
from .state import (FlatAdam, TrainState, flatten_tree, grad_norms,
                    unflatten_like)


def derive_schedules(args: TrainConfig, cfg: RenderConfig, step: int,
                     tau_fixed: Optional[float] = None
                     ) -> Tuple[float, Optional[float]]:
    """tau and the freq-schedule alpha for the current (host) step."""
    if tau_fixed is not None:
        tau = float(tau_fixed)
    else:
        tau = tau_schedule(cfg.embed_kp, step, args.cutoff_step,
                           args.cutoff_rate)
    alpha = None
    if cfg.embed_kp.freq_schedule:
        alpha = alpha_schedule(cfg.embed_kp, step, args.freq_schedule_step,
                               float(args.multires - 1))
    return tau, alpha


def _gather_pose_for_rays(tables: Dict[str, Optional[torch.Tensor]],
                          pose_idx: torch.Tensor, n_rays: int
                          ) -> Dict[str, Optional[torch.Tensor]]:
    """Per-image tables -> per-ray rows. The sampler emits equal
    contiguous ray blocks per image, so that case is a repeat."""
    n_img = next((v.shape[0] for v in tables.values() if v is not None),
                 None)
    if n_img is not None and n_rays % n_img == 0:
        rep = n_rays // n_img
        return {k: None if v is None else v.repeat_interleave(rep, 0)
                for k, v in tables.items()}
    return {k: None if v is None else v[pose_idx] for k, v in tables.items()}


def compute_nerf_loss(args: TrainConfig, batch, rgb_pred, acc_pred,
                      coarse: bool = False):
    """RGB + optional occupancy regularization (trainer.py:353-380)."""
    loss_fn = get_loss_fn(args.loss_fn, args.loss_beta)
    reg_fn = get_reg_fn(args.reg_fn)
    bgs = batch.get('bgs')
    if args.use_background and bgs is not None:
        rgb_pred = rgb_pred + (1.0 - acc_pred)[..., None] * bgs
    rgb_loss = loss_fn(rgb_pred, batch['target_s'], reduction='mean')
    if coarse:
        rgb_loss = rgb_loss * args.coarse_weight
    psnr = img2psnr(rgb_pred.detach(), batch['target_s'])
    suffix = '0' if coarse else ''
    losses = {f'rgb_loss{suffix}': rgb_loss}
    stats = {f'psnr{suffix}': psnr}
    if reg_fn is not None:
        losses[f'reg_loss{suffix}'] = reg_fn(
            acc_pred, batch['fgs'][..., 0], reduction='off') * args.reg_coef
    return losses, stats


def compute_kp_loss(args: TrainConfig, pose_cfg: PoseOptConfig,
                    anchors: Dict[str, torch.Tensor], kp_idxs: torch.Tensor,
                    kps: torch.Tensor, bones: torch.Tensor,
                    rots: torch.Tensor,
                    temp: Optional[Dict[str, torch.Tensor]] = None):
    """Anchor hinge regularization + optional temporal smoothness
    (trainer.py:382-441). All per-image (NI, ...) quantities."""
    if args.opt_rot6d:
        reg_bones = rot_to_rot6d(anchors['rots'][kp_idxs])
        bones_cmp = rot_to_rot6d(rots)
    else:
        reg_bones = anchors['bones'][kp_idxs]
        bones_cmp = bones
    tol = args.opt_pose_tol
    kp_loss = ((reg_bones - bones_cmp) ** 2)[:, 1:]     # root excluded
    kp_loss = torch.where(kp_loss > tol, kp_loss - tol,
                          torch.zeros_like(kp_loss)).sum(-1)
    losses = {'kp_loss': kp_loss.mean() * args.opt_pose_coef}
    if args.use_temp_loss and temp is not None:
        prev_bones, next_bones = (temp['prev_bones'].detach(),
                                  temp['next_bones'].detach())
        prev_kps, next_kps = temp['prev_kps'].detach(), \
            temp['next_kps'].detach()
        ang_vel = ((bones_cmp - prev_bones) - (next_bones - bones_cmp)) ** 2
        joint_vel = ((kps - prev_kps) - (next_kps - kps)) ** 2
        temp_loss = ((ang_vel.sum(-1) + joint_vel.sum(-1))
                     * temp['temp_val'][..., None])
        losses['temp_loss'] = temp_loss.mean() * args.temp_coef
    pjpc = torch.sqrt(((anchors['kps'][kp_idxs] - kps.detach()) ** 2)
                      .sum(-1))
    return losses, {'MPJPC': pjpc.mean() / args.ext_scale}


def _detached(tree):
    if tree is None:
        return None
    return {k: v.detach() for k, v in tree.items()}


def make_train_step(args: TrainConfig, cfg: RenderConfig,
                    pose_cfg: Optional[PoseOptConfig],
                    rest_pose: Optional[torch.Tensor],
                    optimizer: FlatAdam,
                    pose_optimizer: Optional[FlatAdam],
                    pose_frozen: bool = False,
                    tau_fixed: Optional[float] = None,
                    kp_map: Optional[torch.Tensor] = None,
                    rest_pose_idxs: Optional[torch.Tensor] = None,
                    ) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """The train step `step(state, batch, generator) -> (new_state,
    {'losses', 'stats'})`.

    pose_frozen: True after opt_pose_stop (the loop rebuilds the step
    then), detaching the pose params (reference popt_detach,
    trainer.py:240).
    """
    if cfg.embed_kp.freq_schedule:
        raise NotImplementedError('the frequency schedule (freq_schedule) '
                                  'is not ported yet')
    use_pose = pose_cfg is not None and not pose_frozen and args.opt_pose

    def loss_fn(params, pose_params, batch, generator, step):
        tau, _ = derive_schedules(args, cfg, step, tau_fixed)
        if pose_cfg is not None:
            pp = pose_params if use_pose else _detached(pose_params)
            kps_i, bones_i, skts_i, _, rots_i = fk_lookup(
                pp, batch['kp_idxs'], rest_pose, pose_cfg, kp_map,
                rest_pose_idxs)
            tables = {'kp3d': kps_i, 'bones': bones_i, 'skts': skts_i,
                      'cyls': batch['cyls']}
        else:
            tables = {k: batch[k] for k in ('kp3d', 'bones', 'skts', 'cyls')}
        per_ray = _gather_pose_for_rays(tables, batch['pose_idx'],
                                        batch['rays'].shape[0])
        preds = render_rays(
            params, cfg, batch['rays'], per_ray['kp3d'], per_ray['skts'],
            per_ray['bones'], per_ray['cyls'],
            cam_idxs=batch.get('cam_idxs') if args.opt_framecode else None,
            generator=generator, tau=tau)

        losses, stats = compute_nerf_loss(args, batch, preds['rgb_map'],
                                          preds['acc_map'])
        if 'rgb0' in preds:
            l0, s0 = compute_nerf_loss(args, batch, preds['rgb0'],
                                       preds['acc0'], coarse=True)
            losses.update(l0)
            stats.update(s0)
        if use_pose:
            temp = None
            if args.use_temp_loss:
                n_frames = pose_params['pelvis'].shape[0]
                look = lambda idx: fk_lookup(pose_params, idx, rest_pose,
                                             pose_cfg, kp_map,
                                             rest_pose_idxs)
                pk, pb, _, _, pr = look((batch['kp_idxs'] - 1) % n_frames)
                nk, nb, _, _, nr = look((batch['kp_idxs'] + 1) % n_frames)
                if args.opt_rot6d:
                    pb, nb = rot_to_rot6d(pr), rot_to_rot6d(nr)
                temp = {'prev_bones': pb, 'next_bones': nb,
                        'prev_kps': pk, 'next_kps': nk,
                        'temp_val': batch['temp_val']}
            kl, ks = compute_kp_loss(args, pose_cfg, batch['anchors'],
                                     batch['kp_idxs'], kps_i, bones_i,
                                     rots_i, temp)
            losses.update(kl)
            stats.update(ks)
        total = sum(losses.values())
        losses['total_loss'] = total
        stats['alpha'] = torch.mean(preds['acc_map'])
        return total, losses, stats

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        batch = dict(batch)
        if state.anchors is not None:
            batch['anchors'] = state.anchors
        # the trees are views of flat leaf vectors, so autograd delivers
        # the flat gradients the optimizers run over
        flat_p = flatten_tree(state.params).detach().requires_grad_(True)
        params = unflatten_like(flat_p, state.params)
        wrt = [flat_p]
        pose_params = state.pose_params
        if use_pose:
            flat_pp = flatten_tree(pose_params).detach().requires_grad_(True)
            pose_params = unflatten_like(flat_pp, pose_params)
            wrt.append(flat_pp)
        total, losses, stats = loss_fn(params, pose_params, batch, generator,
                                       state.step)
        grads = torch.autograd.grad(total, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if gx is None else gx
                 for x, gx in zip(wrt, grads)]

        # cutoff_dist is never trained (reference cutoff_embedder.py:91-92)
        g_tree = unflatten_like(grads[0], state.params)
        g_tree['cutoff_dist'].zero_()
        total_norm, avg_norm = grad_norms(g_tree)
        updates, new_opt_state = optimizer.update(grads[0], state.opt_state)
        new_params = unflatten_like(flat_p.detach() + updates, state.params)

        new_pose_params = state.pose_params
        new_pose_opt_state = state.pose_opt_state
        new_acc = state.pose_grad_acc
        if use_pose:
            acc = state.pose_grad_acc + grads[1]
            do_step = state.step % args.opt_pose_step == 0
            if args.opt_pose_warmup:
                # poses frozen until the field has formed; warmup grads
                # are dropped, not accumulated (reference
                # core/pose_opt.py:631)
                warm_done = state.step >= args.opt_pose_warmup
                do_step = do_step and warm_done
                if not warm_done:
                    acc = torch.zeros_like(acc)
            if do_step:
                p_updates, new_pose_opt_state = pose_optimizer.update(
                    acc, state.pose_opt_state)
                new_pose_params = unflatten_like(
                    flat_pp.detach() + p_updates, state.pose_params)
                new_acc = torch.zeros_like(acc)
            else:
                new_acc = acc

        stats['total_norm'] = total_norm
        stats['avg_norm'] = avg_norm
        new_state = TrainState(
            step=state.step + 1, params=new_params, opt_state=new_opt_state,
            pose_params=new_pose_params,
            pose_opt_state=new_pose_opt_state, pose_grad_acc=new_acc,
            anchors=state.anchors)
        return new_state, {
            'losses': {k: v.detach() for k, v in losses.items()},
            'stats': {k: v.detach() for k, v in stats.items()}}

    return train_step
