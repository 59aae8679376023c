"""anerf_torch's data parallelism (parallel/mesh.py, through the train
step, the loop and run_nerf.main, render_path(mesh=) and the stdin
server) on the CPU: two gloo ranks spawned by run_ranks (FileStore under
tmp_path, one thread each, every spawn bounded by RANK_TIMEOUT), held
against JAX's sharded functions on a make_mesh(2) of conftest.py's
virtual CPU devices and against the port on one device.

Inputs are made with numpy from a seed; the models are the small ones of
tests/test_torch_loop.py, in test mode (perturb 0, no noise). The ranks
import this module afresh (the spawn start method), so it imports JAX
and tests/helpers.py only inside the functions that run in the test's
own process.

Tolerances, each with what was observed:
  * against JAX's sharded step: tests/test_torch_train.py's bounds,
    losses and stats 1e-4 relative (MPJPC 1e-5 absolute), the stepped
    params 1e-3 relative to the largest value (observed <= 2e-6 and
    3e-7).
  * against the port's one-rank step: losses and stats 1e-6 relative,
    the flat gradients 1e-5 relative in the Frobenius norm (observed
    <= 1.2e-7 and 7e-8): the ranks sum each block's loss and the
    all-reduce sums the blocks, where one device sums the whole batch.
    The ranks' states are bit-equal.
  * render_path against JAX's render_path(mesh=make_mesh(2)): 5e-3 abs /
    rel (tests/test_torch_render.py's LIKE); against one rank at the
    padded chunk: 1e-6 absolute. The stdin server's --eval metrics
    against one rank's: 1e-9 relative (observed 1e-11: the CPU's GEMM
    blocks a bucket's 151 rows and 302 rows differently).
"""
import dataclasses
import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from anerf_torch import run_nerf, run_render
from anerf_torch.config import TrainConfig, save_args_txt
from anerf_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from anerf_torch.data.fixtures import make_synthetic_h5, synthetic_data
from anerf_torch.data.schema import h5_arrays
from anerf_torch.parallel import mesh as tmesh
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.pose.ckpt_compat import export_reference_checkpoint
from anerf_torch.render import raycaster as trc
from anerf_torch.render.factory import build_render_config, init_render_params
from anerf_torch.render.render_path import render_path as t_render_path
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.train import loop as tloop
from anerf_torch.train import state as tst
from anerf_torch.train import trainer as ttrainer

RANK_TIMEOUT = 120.0
# the fused branch of the step cases: K2's weight gradients are rounded
# to bf16 after the ranks' mean (a mean of rounded gradients sat 1.6e-3
# away in the Frobenius norm); an f32 sum-order difference still flips
# an occasional rounding: observed 1.3e-5
FUSED = dict(netwidth=256, netdepth=6, netwidth_fine=256, multires=7,
             multires_views=4, compute_dtype='bfloat16', fused_kernel=True)
FUSED_GRAD_FRO = 1e-4
N_RAYS, N_IMAGES = 32, 4
STEP_KEYS = ('rgb_loss', 'rgb_loss0', 'reg_loss', 'reg_loss0', 'kp_loss',
             'total_loss', 'psnr', 'psnr0', 'MPJPC', 'alpha', 'total_norm',
             'avg_norm')


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-7)


def _fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _ranks(fn, tmp_path, *args):
    return tmesh.run_ranks(fn, 2, ['cpu', 'cpu'], 'gloo', str(tmp_path),
                           args=args, timeout=RANK_TIMEOUT,
                           deadline=RANK_TIMEOUT)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _same_state(a, b):
    """Two train_state_to_numpy dicts equal bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------ shard_ray_batch

@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('n', [2, 8])
def test_shard_ray_batch_matches_jax_shards(n, stacked):
    from anerf_tpu.parallel import mesh as jmesh
    rng = np.random.default_rng(0)
    lead = (3,) if stacked else ()
    batch = {'rays': rng.normal(size=lead + (64, 11)).astype(np.float32),
             'target_s': rng.uniform(size=lead + (64, 3)).astype(np.float32),
             'fgs': rng.uniform(size=lead + (64, 1)).astype(np.float32),
             'bgs': np.ones(lead + (64, 3), np.float32),
             'cam_idxs': rng.integers(0, 4, lead + (64,)),
             'pose_idx': np.repeat(np.arange(4), 16)[None].repeat(
                 3, 0) if stacked else np.repeat(np.arange(4), 16),
             'kp_idxs': rng.integers(0, 8, lead + (4,)),
             'cyls': rng.normal(size=lead + (4, 5)).astype(np.float32),
             'temp_val': None}
    jm = jmesh.make_mesh(n)
    want = jmesh.shard_ray_batch(jm, batch, stacked=stacked)
    for rank in range(n):
        m = tmesh.DataMesh(rank=rank, size=n, group=None,
                           device=torch.device('cpu'))
        got = tmesh.shard_ray_batch(m, batch, stacked=stacked)
        assert got['temp_val'] is None
        for k, v in batch.items():
            if v is None:
                continue
            if k in tmesh.RAY_KEYS:
                dev = jm.devices[rank]
                shard, = [s for s in want[k].addressable_shards
                          if s.device == dev]
                np.testing.assert_array_equal(got[k], np.asarray(shard.data))
            else:
                assert got[k] is v                 # replicated: untouched


def test_mesh_helpers():
    from anerf_tpu.parallel import mesh as jmesh
    m = tmesh.DataMesh(rank=1, size=2, group=None, device=torch.device('cpu'))
    assert m.block(302) == slice(151, 302)
    with pytest.raises(ValueError, match='does not split'):
        m.block(301)
    assert tmesh.pad_to_multiple(301, 2) == 302 == jmesh.pad_to_multiple(
        301, 2)
    assert tmesh.ranks_wanted(3) == 3
    assert tmesh.ranks_wanted(None, 'cpu') == 1
    assert tmesh.ranks_wanted(None, devices=['cpu'] * 2) == 2
    assert tmesh.default_backend('cpu') == 'gloo'
    assert tmesh.default_backend('cuda:0') == 'nccl'
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS


def test_make_mesh_refuses_without_a_group(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(RuntimeError, match='no process group'):
        tmesh.make_mesh()


def test_mesh_device_is_the_cpu_only_when_asked(tmp_path, loop_h5, served,
                                               monkeypatch):
    """Under torchrun (WORLD_SIZE set) on a host with CUDA hidden,
    make_mesh, run_nerf.main and run_render.main raise before they join a
    group, as run_ranks does before it spawns a rank; a rank computes on
    the CPU only when the caller asks for it (device='cpu')."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    for k, v in {'WORLD_SIZE': '1', 'RANK': '0', 'LOCAL_RANK': '0',
                 'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port)
                 }.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (tmesh.make_mesh,
                 lambda: run_nerf.main(_loop_argv(tmp_path, loop_h5, 'g')),
                 lambda: run_render.main(served[0]),
                 lambda: tmesh.run_ranks(_rank_fails, 2, args=('raises',))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
        assert not dist.is_initialized()
    trained = []
    monkeypatch.setattr(tloop, 'train', lambda args, mesh=None, **kw:
                        trained.append((mesh, kw)))
    try:
        run_nerf.main(_loop_argv(tmp_path, loop_h5, 'c'), device='cpu')
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (mesh, kw), = trained
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device('cpu'))
    assert kw == {'device': 'cpu'}


def _rank_collectives(mesh):
    torch.set_num_threads(1)
    mean = tmesh.all_reduce_mean(
        mesh, torch.arange(4, dtype=torch.float32) * (mesh.rank + 1))
    rows = tmesh.all_gather_rows(
        mesh, torch.full((2, 3), float(mesh.rank) - 0.5))
    batch = {'a': np.arange(6, dtype=np.float32).reshape(2, 3),
             'b': np.array([7, 8, 9], np.int64), 'c': None}
    packed = tloop.pack_batch(batch, False) if mesh.rank == 0 else None
    buf, layout = tmesh.broadcast_batch(mesh, packed)
    again, _ = tmesh.broadcast_batch(mesh, packed, layout)
    got = tloop.batch_views(again, layout)
    return (mean.numpy(), rows.numpy(), layout,
            {k: None if v is None else v.numpy() for k, v in got.items()},
            torch.equal(buf, again))


def test_collectives_two_ranks(spawned):
    out = [r['collectives'] for r in spawned['two']]
    for mean, rows, layout, got, same in out:
        np.testing.assert_array_equal(mean, np.arange(4) * 1.5)
        np.testing.assert_array_equal(rows, [[-0.5] * 3] * 2 + [[0.5] * 3] * 2)
        assert same and layout == out[0][2]
        np.testing.assert_array_equal(got['a'], np.arange(6).reshape(2, 3))
        assert got['b'].dtype == np.int64 and got['b'].tolist() == [7, 8, 9]
        assert got['c'] is None


def _rank_fails(mesh, how):
    if mesh.rank == 1:
        if how == 'dies':
            os._exit(3)
        raise ValueError('rank 1 fails on purpose')
    torch.distributed.barrier()


@pytest.mark.parametrize('how, match', [
    ('raises', 'rank 1 fails on purpose'),
    ('dies', r'rank 1 failed:\s+exited with code 3 and no result')])
def test_run_ranks_raises_when_a_rank_fails(tmp_path, how, match):
    """A rank that raises, or exits without a result, fails the run (rank
    0, left in a collective, is stopped)."""
    with pytest.raises(RuntimeError, match=match):
        tmesh.run_ranks(_rank_fails, 2, ['cpu', 'cpu'], 'gloo',
                        str(tmp_path), args=(how,), timeout=RANK_TIMEOUT,
                        deadline=RANK_TIMEOUT)


# ---------------------------------------------------------------- the step

def _step_cases():
    """The deterministic step (perturb 0, no noise, rot6d pose refinement
    applied on step 0, --reg_fn BCE) on two batches of 32 rays over 4
    images, 'aimed' and 'miss': in 'miss', rank 1's block (rays 16-31)
    runs along x, 3 units off every cylinder's axis. The density is a
    softplus shifted by 26, so that no ray's acc_map reaches 1 through
    the last sample's 1e10 interval: there JAX's BCE is inf (XLA rounds
    1 - x + eps to 0) where the port's is finite."""
    import jax
    import jax.numpy as jnp
    from anerf_tpu.pose import pose_opt as jpose
    from anerf_tpu.train import state as jst
    from anerf_tpu.train.trainer import make_train_step as j_make_train_step
    from helpers import build_tiny, synthetic_batch

    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, opt_pose=True, opt_rot6d=True, opt_pose_step=2,
        opt_pose_coef=2.0, opt_pose_tol=0.01, reg_fn='BCE',
        density_type='softplus', softplus_shift=26.0)
    batch = {k: np.asarray(v) for k, v in synthetic_batch(
        rng, pose, n_rays=N_RAYS, n_images=N_IMAGES).items()}
    rays = batch['rays'].copy()
    rays[N_RAYS // 2:, 3:6] = [2.0, 0.0, 0.0]
    rays[N_RAYS // 2:, 8:11] = [1.0, 0.0, 0.0]
    batches = {'aimed': batch, 'miss': dict(batch, rays=rays)}
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    opt = jst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                  args.lrate_decay_rate, args.decay_unit)
    popt = jst.make_pose_optimizer(args.opt_pose_lrate,
                                   args.opt_pose_lrate_decay,
                                   args.opt_pose_decay_rate,
                                   args.opt_pose_decay_unit)
    pose_params = jpose.init_pose_params(pose['kp3d'], pose['bones'], jpc)
    pose_opt_state, pose_acc = jst.init_pose_opt_state(popt, pose_params)
    jstate = jst.TrainState(
        step=jnp.int32(0), params=params,
        opt_state=jst.init_opt_state(opt, params), pose_params=pose_params,
        pose_opt_state=pose_opt_state, pose_grad_acc=pose_acc,
        anchors=jpose.pose_anchor_tree(pose['kp3d'], pose['bones']))
    jstep = j_make_train_step(args, cfg.test_mode(), jpc,
                              jnp.asarray(pose['rest_pose']), opt, popt,
                              raw=True, tau_fixed=35.0)
    targs = TrainConfig(**dataclasses.asdict(args))
    tcfg = build_render_config(
        targs, {'skel_type': SMPLSkeleton,
                'n_views': pose['kp3d'].shape[0]}).test_mode()
    state = train_state_to_numpy(train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), 'cpu'))
    return {name: dict(jstate=jstate, jstep=jstep, batch=b, targs=targs,
                       tcfg=tcfg, state=state, rest_pose=pose['rest_pose'],
                       jcfg=cfg, params=params, pose=pose)
            for name, b in batches.items()}


def _multiview_case(c):
    """Case `c` with multi-view pose sharing (--multiview): frames 2k and
    2k + 1 share their bones through kp_map (pose_opt.gather_rows)."""
    targs = dataclasses.replace(c['targs'], multiview=True)
    kp_map = np.repeat(np.arange(4), 2)
    pcfg = tpose.PoseOptConfig(use_rot6d=True, multiview=True)
    pose_params = tpose.init_pose_params(
        c['pose']['kp3d'], c['pose']['bones'], pcfg, kp_map=kp_map,
        kp_uidxs=np.arange(0, 8, 2), device='cpu')
    popt = tst.make_pose_optimizer(targs.opt_pose_lrate,
                                   targs.opt_pose_lrate_decay,
                                   targs.opt_pose_decay_rate,
                                   targs.opt_pose_decay_unit)
    pose_opt_state, pose_acc = tst.init_pose_opt_state(popt, pose_params)
    state = dataclasses.replace(
        train_state_from_numpy(c['state'], 'cpu'), pose_params=pose_params,
        pose_opt_state=pose_opt_state, pose_grad_acc=pose_acc)
    return dict(c, targs=targs, state=train_state_to_numpy(state),
                kp_map=kp_map)


def _fused_case(c):
    """Case `c` on the fused branch (FUSED; K1 / K2's plain versions on
    the CPU) with the port's own seeded weights: for the port alone."""
    targs = dataclasses.replace(c['targs'], **FUSED)
    tcfg = build_render_config(targs, {'skel_type': SMPLSkeleton,
                                       'n_views': len(c['pose']['kp3d'])})
    params = init_render_params(targs, tcfg,
                                torch.Generator().manual_seed(0), 'cpu')
    opt = tst.make_nerf_optimizer(targs.lrate, targs.lrate_decay,
                                  targs.lrate_decay_rate, targs.decay_unit)
    state = dataclasses.replace(
        train_state_from_numpy(c['state'], 'cpu'), params=params,
        opt_state=tst.init_opt_state(opt, params))
    return dict(c, targs=targs, tcfg=tcfg.test_mode(),
                state=train_state_to_numpy(state))


def _port_step(mesh, targs, tcfg, state, batch, rest_pose, kp_map=None):
    """One port step (mesh None: one device): its losses and stats, the
    flat gradients the optimizers got, the new state, and render_rays'
    near / far and rgb_map of the rays this process rendered."""
    torch.set_num_threads(1)
    opt = tst.make_nerf_optimizer(targs.lrate, targs.lrate_decay,
                                  targs.lrate_decay_rate, targs.decay_unit)
    popt = tst.make_pose_optimizer(targs.opt_pose_lrate,
                                   targs.opt_pose_lrate_decay,
                                   targs.opt_pose_decay_rate,
                                   targs.opt_pose_decay_unit)
    seen = {}

    def spy(name, update):
        def call(g, s):
            seen[name] = g.clone()
            return update(g, s)
        return call

    opt.update, popt.update = (spy('nerf', opt.update),
                               spy('pose', popt.update))
    rendered = {}
    render_rays = ttrainer.render_rays

    def spy_render(*a, **kw):
        out = render_rays(*a, **kw)
        nf = kw['near_far'] or trc.ray_near_far(a[2], a[6])
        rendered.update(near=nf[0].numpy(), far=nf[1].numpy(),
                        rgb=out['rgb_map'].detach().numpy())
        return out

    # what each all-reduce carried: the step's own and fused_apply's
    # (whose backward imports it from the mesh module when it runs)
    reduced = []
    mean_step, mean_mesh = ttrainer.all_reduce_mean, tmesh.all_reduce_mean

    def spy_mean(who, mean):
        def call(m, flat):
            reduced.append((who, flat.numel()))
            return mean(m, flat)
        return call

    ttrainer.render_rays = spy_render
    ttrainer.all_reduce_mean = spy_mean('step', mean_step)
    tmesh.all_reduce_mean = spy_mean('fused', mean_mesh)
    try:
        step = ttrainer.make_train_step(
            targs, tcfg,
            tpose.PoseOptConfig(use_rot6d=True, multiview=targs.multiview),
            torch.as_tensor(rest_pose), opt, popt, tau_fixed=35.0,
            kp_map=None if kp_map is None else torch.as_tensor(kp_map),
            mesh=mesh)
        tb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
        for k in ('cam_idxs', 'pose_idx', 'kp_idxs'):
            tb[k] = tb[k].long()
        new, out = step(train_state_from_numpy(state, 'cpu'), tb, None)
    finally:
        ttrainer.render_rays = render_rays
        ttrainer.all_reduce_mean, tmesh.all_reduce_mean = (mean_step,
                                                           mean_mesh)
    return {'out': {g: {k: float(v) for k, v in out[g].items()}
                    for g in ('losses', 'stats')},
            'grads': {k: v.numpy() for k, v in seen.items()},
            'state': train_state_to_numpy(new), 'reduced': reduced,
            **rendered}


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    """One spawn of two ranks for the collectives, both step batches
    ('aimed', 'miss') and the render. Per batch: the case, JAX's step on
    the batch sharded over make_mesh(2), the port's step on one device
    ('one') and on the ranks ('two'); the render's case and the ranks'
    render_path outputs."""
    import jax
    from anerf_tpu.parallel import mesh as jmesh

    cases = _step_cases()
    jstep = jax.jit(cases['aimed']['jstep'])     # the same step for both
    for c in cases.values():
        sharded = jmesh.shard_ray_batch(jmesh.make_mesh(2), c['batch'])
        c['jax'] = jax.tree.map(np.asarray, jstep(
            c['jstate'], sharded, jax.random.PRNGKey(0)))
    cases['fused'] = _fused_case(cases['aimed'])
    cases['multiview'] = _multiview_case(cases['aimed'])
    for c in cases.values():
        c['one'] = _port_step(None, *(c[k] for k in (
            'targs', 'tcfg', 'state', 'batch', 'rest_pose')),
            c.get('kp_map'))
    render = _render_case(cases['aimed'])
    two = _ranks(_rank_all, tmp_path_factory.mktemp('spawned'),
                 {name: [c[k] for k in ('targs', 'tcfg', 'state', 'batch',
                                        'rest_pose')] + [c.get('kp_map')]
                  for name, c in cases.items()}, render[2:])
    for name, c in cases.items():
        c['two'] = [r[name] for r in two]
    return {'steps': cases, 'render': render, 'two': two}


@pytest.fixture(scope='module')
def steps(spawned):
    return spawned['steps']


def _rank_all(mesh, step_inputs, render_inputs):
    out = {name: _port_step(mesh, *a) for name, a in step_inputs.items()}
    out['collectives'] = _rank_collectives(mesh)
    out['render'] = _port_render(mesh, *render_inputs, RENDER_CHUNK)
    return out


@pytest.mark.parametrize('batch', ['aimed', 'miss'])
def test_two_rank_step_matches_jax_sharded_step(steps, batch):
    from jax.flatten_util import ravel_pytree
    c = steps[batch]
    jnew, jout = c['jax']
    got = c['two'][0]
    assert set(got['out']['losses']) | set(got['out']['stats']) == \
        set(STEP_KEYS)
    for grp in ('losses', 'stats'):
        for k, v in jout[grp].items():
            a, b = float(v), got['out'][grp][k]
            if k == 'MPJPC':
                assert abs(a - b) < 1e-5, (k, a, b)
            else:
                assert abs(a - b) <= 1e-4 * max(abs(a), 1e-6), (k, a, b)
    assert _relmax(ravel_pytree(jnew.params)[0],
                   ravel_pytree(got['state']['params'])[0]) < 1e-3
    assert _relmax(jnew.pose_opt_state[0].mu,
                   got['state']['pose_opt_state']['mu']) < 2e-2


@pytest.mark.parametrize('batch', ['aimed', 'miss', 'fused', 'multiview'])
def test_two_rank_step_matches_one_rank(steps, batch):
    c = steps[batch]
    one, (r0, r1) = c['one'], c['two']
    # every rank ends with the same state, bit for bit
    assert _same_state(r0['state'], r1['state'])
    for grp in ('losses', 'stats'):
        assert set(r0['out'][grp]) == set(one['out'][grp])
        for k, want in one['out'][grp].items():
            for r in (r0, r1):
                assert r['out'][grp][k] == r0['out'][grp][k], k
            assert abs(r0['out'][grp][k] - want) <= 1e-6 * max(
                abs(want), 1e-6), (k, r0['out'][grp][k], want)
    assert r0['out']['losses']['reg_loss'] > 0        # the BCE 'off' term
    for name in ('nerf', 'pose'):
        for r in (r0, r1):
            np.testing.assert_array_equal(r['grads'][name],
                                          r0['grads'][name])
        tol = FUSED_GRAD_FRO if batch == 'fused' else 1e-5
        assert _fro(r0['grads'][name], one['grads'][name]) < tol, name
    assert np.abs(one['grads']['pose']).max() > 0
    # each rank rendered its block of the rays the one device rendered
    for key in ('near', 'far', 'rgb'):
        np.testing.assert_array_equal(
            np.concatenate([r0[key], r1[key]]), one[key], err_msg=key)


@pytest.mark.parametrize('batch', ['aimed', 'fused'])
def test_step_averages_each_gradient_once(steps, batch):
    """One all-reduce a step carries the flat gradients and the logged
    values; on the fused branch it leaves out the networks' weights and
    biases, which fused_apply's backward averaged (once for the coarse
    network, once for the fine one), so no gradient crosses twice."""
    from anerf_torch.kernels.fused_render import mesh_averaged_leaves
    c = steps[batch]
    state = train_state_from_numpy(c['state'], 'cpu')
    n_net = sum(x.numel() for x in mesh_averaged_leaves(c['tcfg'].nerf,
                                                        state.params))
    r0 = c['two'][0]
    n_logged = len(r0['out']['losses']) + len(r0['out']['stats']) - 2
    n_step = (tst.flatten_tree(state.params).numel()
              + tst.flatten_tree(state.pose_params).numel() + n_logged)
    steps_own = [n for who, n in r0['reduced'] if who == 'step']
    fused = [n for who, n in r0['reduced'] if who == 'fused']
    if batch == 'fused':
        assert n_net > 0 and steps_own == [n_step - n_net]
        assert len(fused) == 2
    else:
        assert steps_own == [n_step] and fused == []
    assert c['two'][1]['reduced'] == r0['reduced']


def test_a_block_that_misses_takes_the_whole_batch_fill(steps):
    """Rank 1's rays all miss: their near / far are the mean over the
    whole batch's hits (rank 0's), as on one device, where a mean over
    the block's own rays (no hits) would fall back to the packed bounds
    (far 6)."""
    c = steps['miss']
    r1 = c['two'][1]
    rays = torch.as_tensor(c['batch']['rays'])
    cyls = torch.as_tensor(np.array(c['batch']['cyls']))[
        torch.as_tensor(c['batch']['pose_idx']).long()]
    half = slice(N_RAYS // 2, None)
    own_near, own_far = trc.ray_near_far(rays[half], cyls[half])
    np.testing.assert_array_equal(own_near.numpy(), rays[half, 6:7].numpy())
    np.testing.assert_array_equal(own_far.numpy(), rays[half, 7:8].numpy())
    assert np.all(r1['far'] < 0.5 * own_far.numpy())
    np.testing.assert_array_equal(r1['near'], c['one']['near'][half])
    np.testing.assert_array_equal(r1['far'], c['one']['far'][half])


# ---------------------------------------------------------- render_path

def _camera_ring(kps, n_views=2, radius=3.0):
    center = kps[:, 0].mean(0)
    c2ws = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = center + radius * np.array(
            [np.sin(ang), 0.1, np.cos(ang)], np.float32)
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, np.array([0., 1., 0.], np.float32))
        right = right / np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(right, fwd), -fwd
        c2w[:3, 3] = eye
        c2ws.append(c2w)
    return np.stack(c2ws)


RENDER_CHUNK = 61     # pads to 62 over two ranks


def _render_case(c):
    """A 40 x 40 render of two views of step case `c`'s model: (JAX cfg,
    JAX params, port cfg, numpy params, the path's poses, keywords)."""
    import jax

    pose = c['pose']
    kw = dict(cam_idxs=np.zeros(2, np.int32), tau=100.0, white_bkgd=True,
              use_framecode_idx=True)
    return (c['jcfg'], c['params'], c['tcfg'],
            jax.tree.map(np.asarray, c['params']),
            (_camera_ring(pose['kp3d']), (40, 40, 50.0), pose['kp3d'],
             pose['skts'], pose['bones']), kw)


def _port_render(mesh, tcfg, params_np, data, kw, chunk):
    torch.set_num_threads(1)
    return t_render_path(params_from_numpy(params_np, 'cpu'), tcfg, *data,
                         chunk=chunk, mesh=mesh, **kw)


def test_render_path_mesh_matches_jax_and_one_rank(spawned):
    """chunk 61 pads to 62 over two ranks, as JAX pads it over
    make_mesh(2) (tests/test_mesh_render.py:57)."""
    from anerf_tpu.parallel import mesh as jmesh
    from anerf_tpu.render.render_path import render_path as j_render_path

    cfg, params, tcfg, params_np, data, kw = spawned['render']
    want = j_render_path(params, cfg, *data, chunk=RENDER_CHUNK,
                         mesh=jmesh.make_mesh(2), **kw)
    one = _port_render(None, tcfg, params_np, data, kw, 62)
    two = [r['render'] for r in spawned['two']]
    assert want['accs'].max() > 0.01
    for k in ('rgbs', 'disps', 'accs'):
        np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=k)
        np.testing.assert_allclose(two[0][k], want[k], atol=5e-3, rtol=5e-3,
                                   err_msg=k)
        np.testing.assert_allclose(two[0][k], one[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(two[0]['bboxes'], want['bboxes'])
    n = [int(np.prod(br - tl)) for tl, br in want['bboxes']]
    assert min(n) > 62                          # buckets a pose: 2 or more


# ------------------------------------------------------------ the loop

def _loop_argv(tmp_path, h5, expname):
    return ['--expname', expname, '--basedir', str(tmp_path),
            '--dataset_type', 'h5', '--subject', h5, '--netdepth', '2',
            '--netwidth', '32', '--netwidth_fine', '32', '--multires', '3',
            '--multires_views', '2', '--N_samples', '8', '--N_importance',
            '4', '--N_rand', '32', '--N_sample_images', '2',
            '--use_viewdirs', '--use_cutoff', '--cutoff_viewdir',
            '--cutoff_inputs', '--use_background', '--opt_framecode',
            '--ext_scale', '0.001', '--opt_pose', '--opt_rot6d',
            '--opt_pose_step', '2', '--n_iters', '4', '--scan_unroll', '2',
            '--i_print', '2', '--i_weights', '4', '--i_pose_weights', '4',
            '--i_testset', '4', '--chunk', '1024', '--compute_dtype',
            'float32', '--num_workers', '2', '--seed', '0']


def _rank_loop(mesh, argv):
    """What run_nerf.main's spawned ranks run (run_nerf._rank), as a rank
    of `mesh`: the digest of every super-batch the rank stepped on and of
    its final params, its final step and validation boxes, and _rank's
    result. TensorBoard is kept out (importing it takes seconds here):
    metrics.jsonl stays."""
    from anerf_torch.config import load_config

    torch.set_num_threads(1)
    sys.modules['torch.utils.tensorboard'] = None
    digests, ctxs = [], []
    views, train = tloop.batch_views, tloop.train

    def spy_views(buf, layout):
        digests.append(hashlib.sha1(buf.numpy().tobytes()).hexdigest())
        return views(buf, layout)

    def spy_train(*a, **kw):
        ctxs.append(train(*a, **kw))
        return ctxs[-1]

    tloop.batch_views, tloop.train = spy_views, spy_train
    try:
        tree = run_nerf._rank(mesh, load_config(argv),
                              {'device': 'cpu', 'save_images': False})
    finally:
        tloop.batch_views, tloop.train = views, train
    ctx, = ctxs
    flat = tst.flatten_tree(ctx.state.params).numpy()
    return (digests, hashlib.sha1(flat.tobytes()).hexdigest(),
            ctx.state.step, ctx.val_bboxes, tree)


@pytest.fixture(scope='module')
def loop_h5(tmp_path_factory):
    p = str(tmp_path_factory.mktemp('parallel_loop') / 'syn_train_h5py.h5')
    make_synthetic_h5(p, n_kps=4, n_cams=2, H=32, W=32)
    return p


def test_loop_ranks_share_each_super_batch(tmp_path, loop_h5):
    """Two dispatches of 2 steps on two ranks: only rank 0 loads (two
    loader threads, whose order varies), both ranks step on the same
    super-batches (the broadcast's bytes), end with the same params and
    run the validation render at step 4 together; rank 0 alone writes
    metrics.jsonl (a record a print) and the one checkpoint, which holds
    the state rank 0 returns."""
    argv = _loop_argv(tmp_path, loop_h5, 'dp')
    (d0, p0, s0, v0, tree), (d1, p1, s1, v1, none) = _ranks(
        _rank_loop, tmp_path, argv)
    assert len(d0) == 2 and len(set(d0)) == 2 and d0 == d1
    assert p0 == p1 and s0 == s1 == 4
    np.testing.assert_array_equal(v0, v1)
    exp = os.path.join(str(tmp_path), 'dp')
    assert sorted(os.listdir(os.path.join(exp, 'checkpoints'))) == ['4']
    with open(os.path.join(exp, 'metrics.jsonl')) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r['step'] for r in recs if 'total_loss' in r] == [2, 4]
    assert [r['step'] for r in recs if 'val/psnr' in r] == [4]
    assert all(np.isfinite(r['total_loss']) for r in recs
               if 'total_loss' in r)
    saved = torch.load(os.path.join(exp, 'checkpoints', '4', 'state.pt'))
    assert none is None and tree['step'] == saved['step'] == 4
    for a, b in zip(tst.tree_leaves(tree), tst.tree_leaves(saved)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_dataset_crosses_to_ranks_by_value(loop_h5):
    """A dataset passed to main() reaches spawned ranks pickled: without
    its lock, native handle and open file, remade on the other side, it
    gives the same meta and items."""
    import pickle

    from anerf_torch.data.surreal import SurrealDataset

    ds = SurrealDataset(loop_h5, N_samples=16, split='train', seed=3)
    ds.init_dataset()                       # an open h5 file
    back = pickle.loads(pickle.dumps(ds))
    assert back._native is not None and back.dataset is None
    with back._rng_lock:
        pass
    for k, v in ds.get_meta().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back.get_meta()[k], v)
    a, b = ds.get_item(1), back.get_item(1)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_run_nerf_main_launches_ranks(tmp_path, loop_h5, monkeypatch):
    """run_nerf.main spawns one rank a device by JAX's rule (--mesh_shape,
    or the devices given) and returns rank 0's result; one device trains
    in the caller. (What the ranks run is _rank, which
    test_loop_ranks_share_each_super_batch runs.)"""
    calls = []

    def fake(fn, n, devices, backend, init, args=()):
        calls.append((fn, n, devices, backend, init, args))
        return ['rank 0', None]

    monkeypatch.setattr(tmesh, 'run_ranks', fake)
    argv = _loop_argv(tmp_path, loop_h5, 'main2')
    assert run_nerf.main(argv, devices=['cpu', 'cpu'], backend='gloo',
                         init='x', device='cpu') == 'rank 0'
    assert run_nerf.main(argv + ['--mesh_shape', '2'],
                         device='cpu') == 'rank 0'
    (fn, n, devices, backend, init, (args, kw)), second = calls
    assert fn is run_nerf._rank and n == 2 and backend == 'gloo'
    assert devices == ['cpu', 'cpu'] and init == 'x'
    assert args.expname == 'main2' and kw == {'device': 'cpu'}
    assert second[1] == 2 and [str(d) for d in second[2]] == ['cpu', 'cpu']
    assert second[3] is None


# ---------------------------------------------------------- the server

@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """A 2-camera x 4-pose 32 x 32 experiment (args.txt and a reference
    .tar of seeded random weights) and its data as H5Arrays."""
    base = tmp_path_factory.mktemp('parallel_serve')
    args = TrainConfig(
        expname='srv', basedir=str(base), dataset_type=('surreal',),
        netdepth=2, netwidth=32, netwidth_fine=32, multires=3,
        multires_views=2, N_samples=8, N_importance=4, N_rand=64,
        use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
        cutoff_inputs=True, use_background=True, opt_framecode=True,
        ext_scale=0.001, chunk=302, compute_dtype='float32',
        n_framecodes=2)
    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': 2})
    params = init_render_params(args, cfg, torch.Generator().manual_seed(0),
                                device='cpu')
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] += 2.0
    exp = os.path.join(str(base), 'srv')
    os.makedirs(exp)
    save_args_txt(args, exp)
    tar = os.path.join(exp, 'model.tar')
    export_reference_checkpoint(tar, params_to_numpy(params),
                                global_step=8, tau=20.0)
    data = h5_arrays(synthetic_data(n_kps=4, n_cams=2, H=32, W=32))
    argv = ['--nerf_args', os.path.join(exp, 'args.txt'), '--ckptpath', tar,
            '--dataset', 'surreal', '--entry', 'female', '--runname', 'r',
            '--outputdir', os.path.join(exp, 'out'), '--no_save', '--server']
    return argv, data


REQUESTS = [{'render_type': 'val', 'selected_idxs': [0, 3], 'eval': True,
             'runname': 'a'},
            {'render_type': 'val', 'selected_idxs': [2], 'eval': True,
             'runname': 'b'}]


def _serve(monkeypatch, capfd, argv, **kw):
    # the ranks run main's own rank function: one thread each through the
    # environment they inherit
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.setattr(sys, 'stdin', io.StringIO(
        ''.join(json.dumps(r) + '\n' for r in REQUESTS)))
    capfd.readouterr()
    run_render.main(argv, device='cpu', **kw)
    out = capfd.readouterr().out
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"ok"')]


def _same_replies(one, two):
    """The ranks' replies to REQUESTS against one device's: the same
    requests answered, renders (their --eval metrics) within 1e-9."""
    assert [r.get('runname') for r in two] == ['a', 'b'], (one, two)
    assert [r['n_frames'] for r in two] == [2, 1]
    for a, b in zip(one, two):
        assert a['ok'] and b['ok'], (a, b)
        for k, v in a['eval'].items():
            assert abs(b['eval'][k] - v) <= 1e-9 * abs(v), (k, a, b)


@pytest.fixture(scope='module')
def one_device_replies(served):
    """REQUESTS through serve() on one device."""
    argv, data = served
    stdout = io.StringIO()
    run_render.serve(run_render.config_parser().parse_args(argv),
                     stdin=io.StringIO(''.join(json.dumps(r) + '\n'
                                               for r in REQUESTS)),
                     stdout=stdout, device='cpu', h5=data)
    return [json.loads(ln) for ln in stdout.getvalue().splitlines()][1:]


def test_stdin_server_two_ranks(served, one_device_replies, monkeypatch,
                                capfd, tmp_path):
    """run_render.main --server over two CPU devices: the requests reach
    rank 0 through the relayed stdin; one ready line and exactly one
    reply a request, from rank 0 alone, whose renders equal the
    one-device server's."""
    argv, data = served
    two = _serve(monkeypatch, capfd, argv, h5=data, devices=['cpu', 'cpu'],
                 backend='gloo', init=str(tmp_path))
    assert [r.get('ready', False) for r in two] == [True, False, False], two
    _same_replies(one_device_replies, two[1:])


def _rank_tcp(mesh, argv, data, ready_path):
    """serve_tcp as a rank of `mesh`: rank 0 writes its ready line to
    `ready_path` and listens."""
    torch.set_num_threads(1)
    args = run_render.config_parser().parse_args(argv)
    sess = run_render.RenderSession(args, h5=data, mesh=mesh)
    with open(ready_path if mesh.rank == 0 else os.devnull, 'w') as out:
        run_render.serve_tcp(args, port=0, stdout=out, session=sess)


def test_tcp_server_two_ranks(served, one_device_replies, tmp_path):
    """serve_tcp on two ranks: a client's requests on one connection get
    one reply each, in order, equal to one device's; a quit stops every
    rank."""
    import socket
    import threading
    import time

    argv, data = served
    ready = tmp_path / 'ready'
    ranks = {}

    def run():
        try:
            ranks['out'] = _ranks(_rank_tcp, tmp_path, argv, data,
                                  str(ready))
        except BaseException as e:
            ranks['error'] = e

    th = threading.Thread(target=run)
    th.start()
    end = time.monotonic() + RANK_TIMEOUT
    while not (ready.exists() and ready.read_text().endswith('\n')):
        assert th.is_alive() and time.monotonic() < end, ranks
        time.sleep(0.1)
    port = json.loads(ready.read_text())['port']
    with socket.create_connection(('127.0.0.1', port),
                                  timeout=RANK_TIMEOUT) as s:
        f = s.makefile('r', encoding='utf-8')
        s.sendall(''.join(json.dumps(r) + '\n'
                          for r in REQUESTS).encode())
        replies = [json.loads(f.readline()) for _ in REQUESTS]
        s.sendall(b'{"cmd": "quit"}\n')
        assert json.loads(f.readline()) == {'ok': True, 'bye': True}
    th.join(RANK_TIMEOUT)
    assert not th.is_alive() and 'error' not in ranks, ranks
    _same_replies(one_device_replies, replies)
