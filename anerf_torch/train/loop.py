"""Training orchestration: setup, iteration loop, logging, checkpoints, val
(torch port of anerf_tpu/train/loop.py).

The equivalent of reference run_nerf.py:491-625 + Trainer wiring
(core/trainer.py:205-283), with the JAX package's control flow: the
loader's worker threads assemble pre-stacked super-batches of
`scan_unroll` batches (BatchLoader(stack=scan_unroll)); each goes to the
device in one pinned, non-blocking copy (`upload_batch`) and through the
scanned step (trainer.make_train_step_scan) as one dispatch; the print,
checkpoint, pose-snapshot and validation intervals fire when a multiple
of theirs lies inside the dispatch's steps.

Data parallel (`mesh=`, a parallel/mesh.py DataMesh: one process per
device, which run_nerf.py launches): rank 0 alone runs the loader, and
each dispatch's packed super-batch reaches every rank in one broadcast;
each step renders the rank's block of it and averages the gradients
(train/trainer.py). Rank 0 alone prints and writes metrics.jsonl,
args.txt, checkpoints, pose snapshots and validation images; every rank
restores the same checkpoint and runs the validation render
(render_path(mesh=)), so every rank reaches every collective in the
same order. The JAX package's XLA compile cache has no counterpart;
without a mesh the loop runs on one device ('cuda' unless the caller
passes 'cpu').
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig, save_args_txt
from ..data.pipeline import BatchLoader
from ..parallel.mesh import DataMesh, broadcast_batch
from ..pose.pose_opt import (PoseOptConfig, init_pose_params,
                             pose_anchor_tree)
from ..render.factory import build_render_config, init_render_params
from ..render.render_path import render_path
from ..utils.metrics import evaluate_metric_arrays
from .checkpoint import (restore_checkpoint, restore_from_path,
                         save_checkpoint, save_pose_checkpoint)
from .state import (TrainState, freeze_mask_flat, init_opt_state,
                    init_pose_opt_state, make_nerf_optimizer,
                    make_pose_optimizer)
from .trainer import (derive_schedules, make_train_step,
                      make_train_step_scan, stack_batches)


def get_dataset(args: TrainConfig):
    """Dataset construction facade (reference core/load_data.py:87-143)."""
    from ..data.catalog import get_dataset_from_catalog
    from ..data.dataset import ConcatH5Dataset

    subject, dataset_type = list(args.subject), list(args.dataset_type)
    if len(subject) > len(dataset_type):
        if len(dataset_type) != 1:
            raise ValueError(f'{len(subject)} subjects for '
                             f'{len(dataset_type)} dataset types')
        dataset_type = dataset_type * len(subject)

    n_samples = args.N_rand // args.N_sample_images
    n_nms = n_samples * args.P_nms
    datasets = [get_dataset_from_catalog(args, n_samples, d, s, n_nms)
                for d, s in zip(dataset_type, subject)]
    if len(datasets) == 1:
        return datasets[0]
    return ConcatH5Dataset(datasets)


def _host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    return torch.empty((nbytes,), dtype=torch.uint8, pin_memory=pin)


def pack_batch(batch: Dict[str, Optional[np.ndarray]], pin: bool):
    """The batch's leaves packed into one host byte buffer (pinned when
    `pin`), each at an 8-byte aligned offset. Returns (buffer, layout):
    layout = (total bytes, ((key, offset, dtype, shape), ...)), offset
    None for a None leaf, what batch_views reads back."""
    leaves = {k: None if v is None else np.ascontiguousarray(v)
              for k, v in batch.items()}
    entries, total = [], 0
    for k, v in leaves.items():
        if v is None:
            entries.append((k, None, None, None))
            continue
        entries.append((k, total, v.dtype.str, v.shape))
        total += -(-v.nbytes // 8) * 8
    host = _host_buffer(total, pin)
    buf = host.numpy()
    for k, off, _, _ in entries:
        if off is not None:
            v = leaves[k]
            buf[off:off + v.nbytes] = v.reshape(-1).view(np.uint8)
    return host, (total, tuple(entries))


def batch_views(buf: torch.Tensor, layout
                ) -> Dict[str, Optional[torch.Tensor]]:
    """pack_batch's buffer (on any device) viewed back per leaf."""
    out: Dict[str, Optional[torch.Tensor]] = {}
    for k, off, dtype, shape in layout[1]:
        if off is None:
            out[k] = None
            continue
        dt = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        n = int(np.prod(shape)) * dt.itemsize
        out[k] = buf[off:off + n].view(dt).view(shape)
    return out


def upload_batch(batch: Dict[str, Optional[np.ndarray]],
                 device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """A numpy batch on `device` in ONE copy: pack_batch's buffer, pinned
    and copied with non_blocking=True when the device is a GPU, viewed
    back per leaf on the device. None leaves stay None."""
    on_gpu = device.type == 'cuda'
    host, layout = pack_batch(batch, on_gpu)
    return batch_views(host.to(device, non_blocking=on_gpu), layout)


@dataclasses.dataclass
class TrainContext:
    args: TrainConfig
    cfg: Any
    state: TrainState
    step_fn: Any
    loader: Any
    data_attrs: Dict[str, Any]
    render_data: Dict[str, Any]
    optimizer: Any
    pose_optimizer: Any
    pose_cfg: Optional[PoseOptConfig]
    rest_pose: Optional[torch.Tensor]
    exp_dir: str
    start_step: int
    device: torch.device
    step_kwargs: Dict[str, Any]
    # the (N, 2, 2) [tl, br] ray boxes of the last validation render
    val_bboxes: Optional[np.ndarray] = None
    mesh: Optional[DataMesh] = None

    @property
    def is_main(self) -> bool:
        """Rank 0 (or the one device): the rank that writes and prints."""
        return self.mesh is None or self.mesh.rank == 0


def setup(args: TrainConfig, dataset=None, device='cuda',
          mesh: Optional[DataMesh] = None) -> TrainContext:
    """The run's context. With a data-parallel `mesh` it runs on every
    rank, on the rank's device: N_rand must split over the ranks, and
    only rank 0 writes args.txt and builds the loader."""
    dev = resolve_device(device if mesh is None else mesh.device)
    main = mesh is None or mesh.rank == 0
    if mesh is not None and args.N_rand % mesh.size:
        raise ValueError(f'N_rand {args.N_rand} does not split over a '
                         f'mesh of {mesh.size}')
    exp_dir = os.path.join(args.basedir, args.expname)
    os.makedirs(exp_dir, exist_ok=True)

    if dataset is None:
        dataset = get_dataset(args)
    data_attrs = dataset.get_meta()

    # pin the resolved framecode count into the experiment snapshot so a
    # render-time re-parse reconstructs the exact architecture (the
    # reference instead digs it out of the ckpt weights, run_render.py:95-99)
    if args.n_framecodes is None:
        args = dataclasses.replace(args,
                                   n_framecodes=int(data_attrs['n_views']))
    if main:
        save_args_txt(args, exp_dir)
    render_data = dataset.get_render_data()
    unroll_ = max(1, args.scan_unroll)
    loader = None
    if main:
        loader = BatchLoader(dataset, n_images=args.N_sample_images,
                             prefetch=4,
                             seed=args.seed,
                             num_workers=min(max(args.num_workers, 1), 8),
                             stack=unroll_,
                             stack_fn=stack_batches if unroll_ > 1
                             else None)

    cfg = build_render_config(args, data_attrs)
    params = init_render_params(args, cfg,
                                torch.Generator().manual_seed(args.seed),
                                device=dev)

    freeze = None
    if args.finetune and args.fix_layer > 0:
        freeze = freeze_mask_flat(params, args.fix_layer)
    optimizer = make_nerf_optimizer(args.lrate, args.lrate_decay,
                                    args.lrate_decay_rate, args.decay_unit,
                                    freeze_mask=freeze)

    pose_cfg = None
    pose_optimizer = None
    pose_params = pose_opt_state = pose_acc = anchors = None
    rest_pose = None
    if args.opt_pose:
        pose_cfg = PoseOptConfig(use_rot6d=args.opt_rot6d,
                                 skel=data_attrs['skel_type'],
                                 multiview=args.multiview)
        pose_optimizer = make_pose_optimizer(
            args.opt_pose_lrate, args.opt_pose_lrate_decay,
            args.opt_pose_decay_rate, args.opt_pose_decay_unit)
        pose_params = init_pose_params(
            data_attrs['kp3d'], data_attrs['bones'], pose_cfg,
            kp_map=data_attrs.get('kp_map'),
            kp_uidxs=data_attrs.get('kp_uidxs'), device=dev)
        pose_opt_state, pose_acc = init_pose_opt_state(
            pose_optimizer, pose_params)
        anchors = pose_anchor_tree(data_attrs['kp3d'], data_attrs['bones'],
                                   device=dev)
        rp = np.asarray(data_attrs['rest_pose'], np.float32)
        rest_pose = torch.as_tensor(rp[None] if rp.ndim == 2 else rp,
                                    device=dev)
    elif 'rest_pose' in data_attrs:
        rest_pose = torch.as_tensor(
            np.asarray(data_attrs['rest_pose'], np.float32), device=dev)

    state = TrainState(step=0, params=params,
                       opt_state=init_opt_state(optimizer, params),
                       pose_params=pose_params,
                       pose_opt_state=pose_opt_state,
                       pose_grad_acc=pose_acc,
                       anchors=anchors)

    start_step = 0
    if not args.no_reload:
        if args.ft_path:
            restored = restore_from_path(args.ft_path, state)
        else:
            restored = restore_checkpoint(exp_dir, state)
        if restored is not None:
            state = restored
            start_step = int(state.step)
            if main:
                print(f'resumed from step {start_step}')
            if args.finetune:
                # weights only: reset step + optimizer states
                # (reference raycasters.py:140-142)
                state = dataclasses.replace(
                    state, step=0,
                    opt_state=init_opt_state(optimizer, state.params))
                start_step = 0

    pose_frozen = (args.opt_pose_stop is not None
                   and start_step >= args.opt_pose_stop)
    tau_fixed = None
    if args.finetune or not args.use_cutoff:
        # finetune keeps the annealed tau (effectively saturated)
        tau_fixed = 2000.0 if args.finetune else None
    rp_idxs = data_attrs.get('rest_pose_idxs')
    # multi-view pose sharing: the step gathers a frame's shared bones
    # through kp_map (the JAX loop leaves it out, so its step reads the
    # (U, J-1) shared table as per-frame bones and fails to trace)
    kp_map = data_attrs.get('kp_map') if pose_cfg is not None else None
    step_kwargs = dict(
        tau_fixed=tau_fixed,
        rest_pose_idxs=None if rp_idxs is None
        else torch.as_tensor(np.asarray(rp_idxs), device=dev),
        kp_map=None if kp_map is None
        else torch.as_tensor(np.asarray(kp_map, np.int64), device=dev),
        mesh=mesh)
    step_fn = _make_step(args, cfg, pose_cfg, rest_pose, optimizer,
                         pose_optimizer, pose_frozen, step_kwargs)

    return TrainContext(args=args, cfg=cfg, state=state, step_fn=step_fn,
                        loader=loader, data_attrs=data_attrs,
                        render_data=render_data, optimizer=optimizer,
                        pose_optimizer=pose_optimizer, pose_cfg=pose_cfg,
                        rest_pose=rest_pose, exp_dir=exp_dir,
                        start_step=start_step, device=dev,
                        step_kwargs=step_kwargs, mesh=mesh)


def _make_step(args, cfg, pose_cfg, rest_pose, optimizer, pose_optimizer,
               pose_frozen, step_kwargs):
    """The scanned step when scan_unroll > 1, else the single step."""
    if args.scan_unroll > 1:
        return make_train_step_scan(args, cfg, pose_cfg, rest_pose,
                                    optimizer, pose_optimizer,
                                    unroll=args.scan_unroll,
                                    pose_frozen=pose_frozen, **step_kwargs)
    return make_train_step(args, cfg, pose_cfg, rest_pose, optimizer,
                           pose_optimizer, pose_frozen=pose_frozen,
                           **step_kwargs)


def run_validation(ctx: TrainContext, step: int,
                   max_images: int = 4,
                   save_images: bool = False) -> Dict[str, float]:
    """Periodic held-out render + PSNR/SSIM (run_nerf.py:555-602).

    save_images dumps rgb / GT / disparity / skeleton-overlay pngs under
    exp_dir/val/<step>/ (imageio; the reference writes TB videos instead,
    run_nerf.py:569-600).
    """
    args, rd = ctx.args, ctx.render_data
    n = min(max_images, len(rd['c2ws']))
    tau, _ = derive_schedules(args, ctx.cfg, step)

    H, W, focals = rd['hwf']
    out = render_path(
        ctx.state.params, ctx.cfg,
        rd['c2ws'][:n], (H[:n], W[:n], focals[:n]),
        rd['kp3d'][:n], rd['skts'][:n], rd['bones'][:n],
        cam_idxs=rd['cam_idxs'][:n] if args.opt_framecode else None,
        centers=None if rd.get('center') is None else rd['center'][:n],
        bgs=rd.get('bgs'), bg_idxs=rd.get('bg_idxs'),
        tau=float(tau), chunk=args.chunk, ext_scale=args.ext_scale,
        use_framecode_idx=args.opt_framecode, mesh=ctx.mesh)
    ctx.val_bboxes = out['bboxes']

    metrics = evaluate_metric_arrays(out['rgbs'], rd['imgs'][:n],
                                     fgs=rd['fgs'][:n])

    if save_images:
        import imageio.v2 as imageio

        from ..utils.skeleton_draw import draw_skeletons_3d
        val_dir = os.path.join(ctx.exp_dir, 'val', f'{step:08d}')
        os.makedirs(val_dir, exist_ok=True)
        rgbs8 = (np.clip(out['rgbs'], 0, 1) * 255).astype(np.uint8)
        overlays = draw_skeletons_3d(
            rgbs8, rd['kp3d'][:n], rd['c2ws'][:n],
            int(np.atleast_1d(H)[0]), int(np.atleast_1d(W)[0]),
            np.atleast_1d(focals)[:n])
        for i in range(n):
            imageio.imwrite(os.path.join(val_dir, f'rgb_{i:03d}.png'),
                            rgbs8[i])
            imageio.imwrite(os.path.join(val_dir, f'gt_{i:03d}.png'),
                            (np.clip(rd['imgs'][i], 0, 1) * 255).astype(
                                np.uint8))
            disp = out['disps'][i]
            disp = disp / max(disp.max(), 1e-9)
            imageio.imwrite(os.path.join(val_dir, f'disp_{i:03d}.png'),
                            (disp * 255).astype(np.uint8))
            imageio.imwrite(os.path.join(val_dir, f'skel_{i:03d}.png'),
                            overlays[i])
    return metrics


def train(args: TrainConfig, dataset=None,
          n_iters: Optional[int] = None,
          log_fn=None, device='cuda',
          save_images: bool = True,
          mesh: Optional[DataMesh] = None) -> TrainContext:
    """Main training loop. Returns the final context. With a data-parallel
    `mesh` every rank runs it (module docstring); log_fn is called on
    rank 0.

    Each print record (metrics.jsonl, log_fn) holds the losses and stats
    of the dispatch's last step, the rays/s since the start, and the
    host-clock split of the wall time since the previous print:
    `wait_s` blocked in loader.next(), `upload_s` in upload_batch, and
    `dispatch_s` in all (the steps are the rest; the print reads the
    losses back, which waits for the device). save_images=False writes
    no validation pngs (they need imageio)."""
    ctx = setup(args, dataset, device, mesh)
    main = ctx.is_main
    n_iters = n_iters if n_iters is not None else args.n_iters
    # each rank draws its own noise for its block of rays
    seed = args.seed + 1 + (0 if mesh is None else mesh.rank << 32)
    generator = torch.Generator(device=ctx.device).manual_seed(seed)

    from ..utils.logging import MetricsLogger
    logger = MetricsLogger(ctx.exp_dir) if main else None

    if main:
        ctx.loader.start()
    layout = None
    state = ctx.state
    step_fn = ctx.step_fn
    pose_frozen_rebuilt = False

    unroll = max(1, args.scan_unroll)
    t_start = t_print = time.perf_counter()
    wait_s = upload_s = 0.0
    rays_done = 0
    try:
        for i in range(ctx.start_step, n_iters, unroll):
            # pose freeze threshold crossing: rebuild the step fn once
            if (args.opt_pose and not pose_frozen_rebuilt
                    and args.opt_pose_stop is not None
                    and i >= args.opt_pose_stop):
                step_fn = _make_step(args, ctx.cfg, ctx.pose_cfg,
                                     ctx.rest_pose, ctx.optimizer,
                                     ctx.pose_optimizer, True,
                                     ctx.step_kwargs)
                pose_frozen_rebuilt = True

            # the loader emits pre-stacked unroll-sized super-batches
            # (BatchLoader(stack=unroll)) assembled in its worker threads
            t0 = time.perf_counter()
            batch = ctx.loader.next() if main else None
            t1 = time.perf_counter()
            if mesh is None:
                batch = upload_batch(batch, ctx.device)
            else:
                packed = (pack_batch(batch, ctx.device.type == 'cuda')
                          if main else None)
                buf, layout = broadcast_batch(mesh, packed, layout)
                batch = batch_views(buf, layout)
            t2 = time.perf_counter()
            wait_s += t1 - t0
            upload_s += t2 - t1
            state, out = step_fn(state, batch, generator)
            rays_done += args.N_rand * unroll
            done = i + unroll  # steps completed after this dispatch

            start_of_dispatch = i

            def crossed(interval):
                # a multiple of `interval` lies in (start_of_dispatch, done]
                return done // interval > start_of_dispatch // interval
            i = done - 1  # report the last completed step below

            if main and crossed(args.i_print):
                stats = {k: float(v) for k, v in out['stats'].items()}
                losses = {k: float(v) for k, v in out['losses'].items()}
                now = time.perf_counter()
                rec = {'rays_per_sec': rays_done / (now - t_start),
                       **losses, **stats, 'wait_s': wait_s,
                       'upload_s': upload_s, 'dispatch_s': now - t_print}
                t_print, wait_s, upload_s = now, 0.0, 0.0
                logger.log_scalars(i + 1, rec)
                if log_fn:
                    log_fn({'step': i + 1, **rec})
                else:
                    print(f"[{i + 1}] loss={losses['total_loss']:.4f} "
                          f"psnr={stats.get('psnr', 0):.2f} "
                          f"rays/s={rec['rays_per_sec']:.0f}")

            if main and crossed(args.i_weights):
                ctx.state = state
                save_checkpoint(ctx.exp_dir, state, i + 1)
            if main and args.opt_pose and crossed(args.i_pose_weights):
                ctx.state = state
                save_pose_checkpoint(ctx.exp_dir, state, i + 1)
            if crossed(args.i_testset):
                # every rank renders (render_path's collectives)
                ctx.state = state
                val = run_validation(ctx, i + 1,
                                     save_images=save_images and main)
                if main:
                    logger.log_scalars(i + 1, val, prefix='val/')
                    print(f'[val {i + 1}] ' + ' '.join(
                        f'{k}={v:.3f}' for k, v in val.items()))
    finally:
        if main:
            ctx.loader.stop()
            logger.close()

    ctx.state = state
    return ctx
