"""The general driver of training mixes (`"kind": "train"`): a closed
loop of dispatches of the port's scanned train step
(`train/trainer.py:make_train_step_scan`), each fed a new stacked batch
through the training loop's own upload (`train/loop.py:upload_batch`).

Set-up builds the one train state (weights from the seed, the pose
parameters and both Adams), runs its first dispatch, the one checked,
and `warm_dispatches` in all, so that every kernel is built and every
shape warm. The window then dispatches until `--seconds` have passed and
ends at the synchronize that closes the last dispatch begun inside them.
`train_rays_per_s` is all rays of all its steps over its time.

The check follows two dispatches on the plain reference: the first, from
the seed, and the first after the window, from the state the window left
(the program's parameters, both Adams' moments and counts, the pose
gradient pending). Of each: its last step's loss (the one the scanned
step returns), the first gradients as each Adam got them, and the change
of the parameters over the dispatch, leaf by leaf.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import counts, devtrace, harness, scene
from ..reference import anerf as ref


def recording_adam(base_cls, first: Dict[str, torch.Tensor], tree: str,
                   schedule):
    """An Adam of the program's class that also keeps, in first[tree],
    the gradient it is handed at its first call."""

    class RecordingAdam(base_cls):
        def update(self, g, state):
            if tree not in first:
                first[tree] = g.detach().clone()
            return super().update(g, state)
    return RecordingAdam(schedule)


def model_of(cfg: dict) -> dict:
    """What the reference needs of a configuration."""
    t = cfg['train_config']
    return {'n_samples': t['N_samples'], 'n_importance': t['N_importance'],
            'single_net': bool(t.get('single_net')), 'nfk': t['multires'],
            'nfv': t['multires_views'], 'skips': (4,),
            'raw_noise_std': t['raw_noise_std'],
            'opt_pose_tol': t['opt_pose_tol'],
            'opt_pose_coef': t['opt_pose_coef']}


def leaf_gaps(prog: torch.Tensor, refv: torch.Tensor, tree,
              keep=None) -> Dict[str, float]:
    """{leaf: the gap between the program's and the reference's norms of
    that leaf, over the larger of its reference norm and the median
    leaf's}; `keep` names the leaves compared (default all)."""
    items = ref.tree_items(tree)
    sizes = [t.numel() for _, t in items]
    if sum(sizes) != prog.numel() or prog.numel() != refv.numel():
        raise ValueError(f'flat sizes {prog.numel()} / {refv.numel()} for '
                         f'a tree of {sum(sizes)}')
    pn = [float(x.double().norm()) for x in prog.split(sizes)]
    rn = [float(x.double().norm()) for x in refv.split(sizes)]
    med = float(np.median(rn))
    return {path: abs(a - b) / max(b, med, 1e-30)
            for (path, _), a, b in zip(items, pn, rn)
            if keep is None or path in keep}


def leaf_gap(prog: torch.Tensor, refv: torch.Tensor, tree,
             keep=None) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    gaps = leaf_gaps(prog, refv, tree, keep)
    return max(gaps.values()) if gaps else float('nan')


def large_leaves(tree):
    """Leaves with more elements than the tree's median leaf: the weight
    matrices, the framecodes and the bones, where one layer's gradient
    off by a factor shows whatever Adam makes of it."""
    items = ref.tree_items(tree)
    med = float(np.median([t.numel() for _, t in items]))
    return {p for p, t in items if t.numel() > med}


def moved_leaves(g_ref: torch.Tensor, tree, rule: float = 1e-3):
    """Leaves whose reference gradient is more than `rule` of the median
    leaf's: the others move by round-off alone under Adam."""
    items = ref.tree_items(tree)
    sizes = [t.numel() for _, t in items]
    gn = [float(x.double().norm()) for x in g_ref.split(sizes)]
    med = float(np.median(gn))
    return {p for (p, _), g in zip(items, gn) if g > rule * med}


def _tensors(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in batch.items()}


def snapshot(state) -> dict:
    """The program's state as the reference's `start` takes it (copies):
    both trees flat, both Adams' moments, the pose gradient pending, the
    step and the pose Adam's count."""
    return {'nets_flat': ref._flat(state.params).clone(),
            'pose_flat': ref._flat(state.pose_params).clone(),
            'mu': state.opt_state.mu.clone(), 'nu': state.opt_state.nu.clone(),
            'pmu': state.pose_opt_state.mu.clone(),
            'pnu': state.pose_opt_state.nu.clone(),
            'acc': state.pose_grad_acc.clone(), 'step': int(state.step),
            'pose_count': int(state.pose_opt_state.count)}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, step_wrapper=None) -> dict:
    """One run (harness.run_cell). `step_wrapper` wraps the scanned step
    (the tests' faults)."""
    from anerf_torch import resolve_device
    from anerf_torch.config import TrainConfig
    from anerf_torch.pose.pose_opt import (PoseOptConfig, init_pose_params,
                                           pose_anchor_tree)
    from anerf_torch.render.factory import build_render_config
    from anerf_torch.skeleton import SMPLSkeleton
    from anerf_torch.train.loop import upload_batch
    from anerf_torch.train.state import (FlatAdam, TrainState,
                                         decay_schedule, init_opt_state,
                                         init_pose_opt_state)
    from anerf_torch.train.trainer import make_train_step_scan

    dev = resolve_device(device)
    on_gpu = dev.type == 'cuda'
    sync = (lambda: torch.cuda.synchronize(dev)) if on_gpu else (lambda: None)
    tc, tr = cell.config['train_config'], cell.traffic
    args = TrainConfig(**tc)
    n_frames, unroll = tr['n_frames'], tr['unroll']
    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': n_frames})
    sk, cyls = inputs(cell)

    params = scene.weights(cell.config, n_frames, seed, dev)
    ref_params = scene.clone_tree(params)
    pose_cfg = PoseOptConfig(use_rot6d=args.opt_rot6d)
    first_grads: Dict[str, torch.Tensor] = {}
    opt = recording_adam(FlatAdam, first_grads, 'nerf', decay_schedule(
        args.lrate, args.lrate_decay, args.lrate_decay_rate,
        args.decay_unit))
    popt = recording_adam(FlatAdam, first_grads, 'pose', decay_schedule(
        args.opt_pose_lrate, args.opt_pose_lrate_decay,
        args.opt_pose_decay_rate, args.opt_pose_decay_unit))
    pose_params = init_pose_params(sk['kp3d'], sk['bones'], pose_cfg,
                                   device=dev)
    pose_state, pose_acc = init_pose_opt_state(popt, pose_params)
    state = TrainState(step=0, params=params,
                       opt_state=init_opt_state(opt, params),
                       pose_params=pose_params, pose_opt_state=pose_state,
                       pose_grad_acc=pose_acc,
                       anchors=pose_anchor_tree(sk['kp3d'], sk['bones'],
                                                dev))
    rest = torch.as_tensor(sk['rest'], device=dev)
    step = make_train_step_scan(args, cfg, pose_cfg, rest, opt, popt,
                                unroll=unroll)
    if step_wrapper is not None:
        step = step_wrapper(step)

    # the window's dispatches at `max_dispatch_rate`, the set-up's, the
    # one checked after the window and the traced ones
    n_pool = tr['warm_dispatches'] + int(
        math.ceil(seconds * tr['max_dispatch_rate'])) + 1 + (
        tr['trace_dispatches'] if trace else 0)
    pool = scene.train_batches(sk, cyls, n_pool, unroll, args.N_rand,
                               args.N_sample_images, tr['camera_offset'],
                               tr['target_sigma'], seed)
    gen = torch.Generator(device=dev).manual_seed(scene.seed64(seed))
    span = (torch.profiler.record_function if trace
            else (lambda name: contextlib.nullcontext()))
    used = [0]

    def dispatch(k):
        nonlocal state
        used[0] = max(used[0], k + 1)
        with span('bench.upload'):
            batch = upload_batch(scene.dispatch(pool, k), dev)
        with span('bench.dispatch'):
            state, out = step(state, batch, gen)
        return out

    def checked(k):
        """Dispatch k with what the check compares of it."""
        case = {'batch': scene.dispatch(pool, k),
                'gen_state': gen.get_state(), 'start': snapshot(state)}
        first_grads.clear()
        out = dispatch(k)
        case['prog'] = {
            'loss': float(out['losses']['total_loss']),
            'grads': dict(first_grads),
            'change': {'nerf': ref._flat(state.params)
                       - case['start']['nets_flat'],
                       'pose': ref._flat(state.pose_params)
                       - case['start']['pose_flat']}}
        return case

    # set-up: the checked dispatch, then the others that warm up
    first = checked(0)
    first['start'] = None          # the reference starts from the seed
    for k in range(1, tr['warm_dispatches']):
        dispatch(k)
    sync()
    setup_s = time.perf_counter() - t_start

    k0 = tr['warm_dispatches']
    n_disp, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        dispatch(k0 + n_disp)
        n_disp += 1
    sync()
    dt = time.perf_counter() - t0
    rays = n_disp * unroll * args.N_rand
    # the first dispatch after the window, from the state it left
    late = checked(k0 + n_disp)
    sync()
    e2e = {'train_rays_per_s': rays / dt, 'setup_s': setup_s,
           'window_s': dt, 'dispatches': n_disp}
    ctx = None
    if trace:
        # then a few dispatches under the profiler
        k1 = k0 + n_disp + 1

        def window():
            for k in range(k1, k1 + tr['trace_dispatches']):
                dispatch(k)
            sync()
        _, tra = devtrace.capture(window)
        ctx = _reader_ctx(cell, tra, tr['trace_dispatches'] * unroll,
                          args.N_rand)
        ctx['window_model_flop_per_s'] = counts.model_flop_per_ray(
            cell.config, True) * rays / dt
    if used[0] > len(pool):
        e2e['pool_wrapped'] = True
        print(f'the pool of {len(pool)} dispatches wrapped: {used[0]} '
              f'used; raise the mix\'s max_dispatch_rate', file=sys.stderr)
    dev_info = harness.device_block(torch, dev)

    # the check, once the program's state is freed
    del state, step, opt, popt, params, pose_params, pose_state, pose_acc
    del pool
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    readings = check(cell, sk, ref_params, dev, first, late)
    return {'end_to_end': e2e, 'readings': readings, 'ctx': ctx,
            'attempted': n_disp * unroll, 'failed': 0, 'device': dev_info}


def inputs(cell):
    """The skeleton and its cylinders, as the mix states them."""
    sk = scene.skeleton(cell.traffic['n_frames'])
    tc, cy = cell.config['train_config'], cell.traffic['cylinder']
    cyls = ref.kp_cylinder(sk['kp3d'], tc['ext_scale'], cy['extend_mm'],
                           cy['top_ratio'], cy['bot_ratio'], cy['head'])
    return sk, cyls


def reference_run(cell, sk, params, batch, gen_state, dev, n_steps,
                  lowp=False, half_batch=False, start: Optional[dict] = None):
    """The reference over the first `n_steps` steps of a stacked batch,
    from the seed's weights `params` or from the state `start`:
    ([(losses, nerf grad, nerf update, pose grad, pose update)], the
    reference, its generator after the steps)."""
    ref.strict_f32()
    t = cell.config['train_config']
    bones6 = ref.rot_to_rot6d(ref.axisang_to_rot(
        torch.as_tensor(sk['bones'])))
    pose = {'bones': bones6.to(dev),
            'pelvis': torch.as_tensor(sk['kp3d'][:, 0]).to(dev)}
    if start is not None:
        params = ref._unflatten(start['nets_flat'].to(dev).float().clone(),
                                params)
        pose = ref._unflatten(start['pose_flat'].to(dev).float().clone(),
                              pose)
        start = {k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in start.items()}
    anchors = ref.axisang_to_rot(torch.as_tensor(sk['bones'])).to(dev)
    tref = ref.TrainReference(
        params, pose, anchors, torch.as_tensor(sk['rest'], device=dev),
        model_of(cell.config), t, lowp=lowp, half_batch=half_batch,
        start=start)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    out = []
    for i in range(n_steps):
        b = _tensors({k: v[i] for k, v in batch.items()}, dev)
        out.append(tref.step(b, gen))
    return out, tref, gen


def readings_of(steps) -> dict:
    """What the check compares of a dispatch, from a reference run's
    steps: the last loss, the first gradients, the change."""
    return {'loss': float(steps[-1][0]['total_loss']),
            'grads': {'nerf': steps[0][1], 'pose': next(
                s[3] for s in steps if s[3] is not None)},
            'change': {'nerf': sum(s[2] for s in steps),
                       'pose': sum(s[4] for s in steps
                                   if s[4] is not None)}}


def check(cell, sk, params, dev, first: dict, late: Optional[dict] = None
          ) -> dict:
    """The numbers that decide `correct`, of the first dispatch and (with
    suffix `_late`) of the one after the window. Each case holds the
    dispatch's stacked 'batch', the generator's state before it
    ('gen_state'), the state it starts from ('start', None for the
    seed's) and the program's side ('prog': 'loss', 'grads', 'change').
    Per dispatch: the gap of its last loss; of the first gradients the
    worst leaf's gap, the median leaf's and the worst of the leaves
    larger than the median leaf; of the change the worst and the median
    moved leaf's."""
    out = {}
    for suffix, case in (('', first), ('_late', late)):
        if case is not None:
            out.update(compare(cell, sk, params, dev, case, suffix))
    return out


def compare(cell, sk, params, dev, case: dict, suffix: str = '') -> dict:
    """check's numbers of one dispatch."""
    unroll = cell.traffic['unroll']
    steps, tref, _ = reference_run(cell, sk, params, case['batch'],
                                   case['gen_state'], dev, unroll,
                                   start=case['start'])
    want, got = readings_of(steps), case['prog']
    trees = {'nerf': tref.nets, 'pose': tref.pose}
    out = {'loss_gap': abs(got['loss'] - want['loss'])
           / max(abs(want['loss']), 1e-30),
           'loss': got['loss'], 'ref_loss': want['loss']}
    for t, tree in trees.items():
        if t not in got['grads']:
            for q in ('grad_gap', 'change_gap'):
                for s in ('', '_median', '_large'):
                    out[f'{q}{s}.{t}'] = float('inf')
            continue
        for q, gaps, big in (
                ('grad', leaf_gaps(got['grads'][t].to(dev).float(),
                                   want['grads'][t], tree),
                 large_leaves(tree)),
                ('change', leaf_gaps(got['change'][t].to(dev).float(),
                                     want['change'][t], tree,
                                     moved_leaves(want['grads'][t], tree)),
                 None)):
            worst = max(gaps, key=gaps.get)
            out[f'{q}_gap.{t}'] = gaps[worst]
            out[f'{q}_gap_median.{t}'] = float(np.median(list(gaps.values())))
            if big is not None:
                out[f'{q}_gap_large.{t}'] = max(
                    v for k, v in gaps.items() if k in big)
            print(f'{q}{suffix} {t}: worst {worst} {gaps[worst]:.3g}; '
                  + ', '.join(f'{k} {v:.2g}' for k, v in sorted(
                      gaps.items(), key=lambda kv: -kv[1])[:6]),
                  file=sys.stderr)
    for q in ('grad_gap', 'change_gap', 'grad_gap_median',
              'change_gap_median', 'grad_gap_large'):
        out[q] = max(out.get(f'{q}.nerf', float('inf')),
                     out.get(f'{q}.pose', float('inf')))
    return {k + suffix: v for k, v in out.items()}


def _reader_ctx(cell, tra: dict, steps: int, n_rays: int) -> dict:
    """What the per-layer readers of a traced train window read."""
    net = counts.net_of(cell.config)
    k1 = k2 = 0.0
    for S, _ in counts.passes(cell.config):
        k1 += counts.k1_bound_s(net, n_rays, S)
        k2 += counts.k2_bound_s(net, n_rays, S)
    return {'trace': tra, 'owner_s': devtrace.owner_seconds(tra),
            'steps': steps, 'k1_bound_s': k1 * steps,
            'k2_bound_s': k2 * steps}
