"""anerf_torch's training entry point (train/loop.py, train/checkpoint.py,
the scanned step, run_nerf.py) against anerf_tpu, on the CPU.

The port's train() starts from JAX's setup() state: JAX draws the
initial params from PRNGKey(seed), which torch cannot reproduce, so the
test converts that state (convert.train_state_from_numpy) and saves it as
the port's checkpoint at step 0, from which the port's loop auto-resumes,
as the JAX loop does from its own checkpoints. Both loops read the same
synthetic h5 through datasets seeded alike, one loader thread each, so
they train on the same batches. Deterministic mode (perturb 0,
raw_noise_std 0): threefry draws cannot be reproduced.

Tolerances, each stated where it is used, with what was observed:
  * plain branch (f32, 32 wide): every logged loss and stat 1e-5
    relative (observed 2.2e-7; MPJPC 1e-5 absolute, a float-noise value,
    observed 2.7e-6); the final params and the pose snapshot 2e-5
    relative to the largest value (observed 1.6e-6 and 1.3e-6).
  * fused branch (256 wide, bf16 MLP, K1 / K2 plain versions against the
    Pallas kernels in interpret mode): losses 2e-3 relative (observed
    1.9e-4); params and poses 5e-3 (observed 1.7e-3 and 7.1e-4): a ReLU
    mask can flip between the two bf16 roundings
    (tests/test_torch_fused_bwd.py), and Adam's first updates, about
    lr * sign(g), carry a flipped sign as a whole lr = 5e-4 step.
  * the scanned step: equal to `unroll` single port steps bit for bit;
    against JAX's scanned step the bounds of tests/test_torch_train.py
    (losses 1e-4 relative, Adam's mu 2e-2, params 1e-3).
  * validation metrics: 1e-4 relative (the same f32 render, summed in
    another order).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from anerf_tpu.config import TrainConfig as JTrainConfig
from anerf_tpu.data.dataset import BaseH5Dataset as JBaseH5Dataset
from anerf_tpu.data.dataset import ConcatH5Dataset as JConcatH5Dataset
from anerf_tpu.data.surreal import SurrealDataset as JSurrealDataset
from anerf_tpu.pose import pose_opt as jpose
from anerf_tpu.train import checkpoint as jckpt
from anerf_tpu.train import loop as jloop
from anerf_tpu.train import state as jst
from anerf_tpu.train.trainer import make_train_step_scan as j_scan
from anerf_tpu.train.trainer import stack_batches as j_stack

from anerf_torch.config import TrainConfig
from anerf_torch.convert import train_state_from_numpy
from anerf_torch.data.dataset import BaseH5Dataset, ConcatH5Dataset
from anerf_torch.data.fixtures import make_synthetic_h5
from anerf_torch.data.surreal import SurrealDataset
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.run_nerf import main as run_nerf_main
from anerf_torch.train import checkpoint as tckpt
from anerf_torch.train import loop as tloop
from anerf_torch.train import state as tst
from anerf_torch.train import trainer as ttrainer
from anerf_torch.train.trainer import (make_train_step, make_train_step_scan,
                                       stack_batches)

from helpers import build_tiny, synthetic_batch

LOSS_KEYS = ('rgb_loss', 'rgb_loss0', 'kp_loss', 'total_loss', 'psnr',
             'psnr0', 'MPJPC', 'alpha', 'total_norm', 'avg_norm')


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-7)


def _np(state):
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope='module')
def h5(tmp_path_factory):
    p = tmp_path_factory.mktemp('torch_loop') / 'syn_train_h5py.h5'
    make_synthetic_h5(str(p), n_kps=4, n_cams=2, H=32, W=32)
    return str(p)


def loop_args(basedir, h5, expname, fused=False, **overrides):
    """The JAX TrainConfig of a loop run: 6 steps in dispatches of 2,
    pose refinement (applied every 2nd step, frozen from step 4), prints
    every dispatch, checkpoints every 2 steps, a pose snapshot at 4."""
    kw = dict(
        expname=expname, basedir=str(basedir), dataset_type=('h5',),
        subject=(h5,), netdepth=2, netwidth=32, netwidth_fine=32,
        multires=3, multires_views=2, N_samples=8, N_importance=4,
        N_rand=32, N_sample_images=2, use_viewdirs=True, use_cutoff=True,
        cutoff_viewdir=True, cutoff_inputs=True, use_background=True,
        opt_framecode=True, ext_scale=0.001, perturb=0.0,
        raw_noise_std=0.0, opt_pose=True, opt_rot6d=True, opt_pose_step=2,
        opt_pose_coef=2.0, opt_pose_tol=0.01, opt_pose_stop=4,
        n_iters=6, scan_unroll=2, i_print=2, i_weights=2,
        i_pose_weights=4, i_testset=10 ** 8, chunk=1024,
        compute_dtype='float32', num_workers=0, mesh_shape=1,
        xla_cache_dir='', seed=0)
    if fused:
        kw.update(netdepth=6, netwidth=256, netwidth_fine=256,
                  compute_dtype='bfloat16', fused_kernel=True)
    kw.update(overrides)
    return JTrainConfig(**kw)


def _torch_args(args, **overrides):
    return TrainConfig(**{**dataclasses.asdict(args), **overrides})


def _surreal(cls, h5, args):
    return cls(h5, N_samples=args.N_rand // args.N_sample_images,
               split='train', seed=7)


def _records(exp_dir):
    with open(os.path.join(exp_dir, 'metrics.jsonl')) as f:
        return [r for r in map(json.loads, f) if 'total_loss' in r]


def _seed_port(exp_dir, jstate, step=0):
    """JAX's state as the port's checkpoint at `step` in exp_dir."""
    return tckpt.save_checkpoint(
        exp_dir, train_state_from_numpy(_np(jstate), 'cpu'), step)


def _train_pair(h5, base, fused):
    """JAX's train() and the port's from JAX's initial state, on the same
    batches; returns (args, JAX state at step 0, JAX ctx, port ctx,
    fused)."""
    args = loop_args(base, h5, 'jax', fused)
    state0 = jloop.setup(args, _surreal(JSurrealDataset, h5, args)).state
    state0 = _np(state0)
    jctx = jloop.train(args, _surreal(JSurrealDataset, h5, args))

    targs = _torch_args(args, expname='port')
    _seed_port(os.path.join(targs.basedir, targs.expname), state0)
    tctx = tloop.train(targs, _surreal(SurrealDataset, h5, targs),
                       device='cpu', save_images=False)
    return args, state0, jctx, tctx, fused


@pytest.fixture(scope='module')
def plain_pair(h5, tmp_path_factory):
    return _train_pair(h5, tmp_path_factory.mktemp('plain'), False)


@pytest.fixture(scope='module')
def fused_pair(h5, tmp_path_factory):
    return _train_pair(h5, tmp_path_factory.mktemp('fused'), True)


def _same_tree(a, b):
    """Two checkpoint trees (tckpt.state_tree) equal bit for bit."""
    la, lb = tst.tree_leaves(a), tst.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize('branch', ['plain', 'fused'])
def test_train_matches_jax(request, branch):
    args, _, jctx, tctx, fused = request.getfixturevalue(f'{branch}_pair')
    assert tctx.start_step == 0 and tctx.state.step == int(jctx.state.step)
    loss_tol, param_tol = (2e-3, 5e-3) if fused else (1e-5, 2e-5)
    jrec, trec = _records(jctx.exp_dir), _records(tctx.exp_dir)
    assert [r['step'] for r in trec] == [r['step'] for r in jrec] == [2, 4, 6]
    for a, b in zip(jrec, trec):
        keys = [k for k in LOSS_KEYS if k in a]    # kp_loss, MPJPC: poses
        assert keys == [k for k in LOSS_KEYS if k in b]
        assert ('kp_loss' in keys) == (a['step'] <= 4)
        for k in keys:
            if k == 'MPJPC':
                assert abs(a[k] - b[k]) < 1e-5, (k, a[k], b[k])
            else:
                assert abs(a[k] - b[k]) <= loss_tol * max(abs(a[k]), 1e-6), \
                    (a['step'], k, a[k], b[k])
        assert b['wait_s'] >= 0 and b['upload_s'] >= 0
        assert b['dispatch_s'] >= b['wait_s'] + b['upload_s']
    assert _relmax(ravel_pytree(jctx.state.params)[0],
                   tst.flatten_tree(tctx.state.params).numpy()) < param_tol
    # the pose snapshot at step 4 (poses frozen after it)
    name = os.path.join('pose_checkpoints', '00000004.npz')
    jsnap = jckpt.load_pose_checkpoint(os.path.join(jctx.exp_dir, name))
    tsnap = jckpt.load_pose_checkpoint(os.path.join(tctx.exp_dir, name))
    assert int(tsnap['global_step']) == 4
    for grp in ('pose_params', 'anchors'):
        assert set(tsnap[grp]) == set(jsnap[grp])
        for k in jsnap[grp]:
            assert _relmax(jsnap[grp][k], tsnap[grp][k]) < param_tol, k
    # the poses moved off their anchors
    assert not np.allclose(tsnap['pose_params']['pelvis'],
                           tsnap['anchors']['kps'][:, 0])


def test_loop_checkpoints_and_resume(plain_pair):
    args, _, _, tctx, _ = plain_pair
    ckpts = os.path.join(tctx.exp_dir, 'checkpoints')
    assert sorted(os.listdir(ckpts), key=int) == ['2', '4', '6']   # keep 3
    assert tckpt.latest_checkpoint_step(tctx.exp_dir) == 6
    # resume: setup picks step 6 with the run's final state, bit for bit
    targs = _torch_args(args, expname='port')
    ds = _surreal(SurrealDataset, args.subject[0], targs)
    ctx = tloop.setup(targs, ds, device='cpu')
    assert ctx.start_step == 6
    for a, b in zip(tst.tree_leaves(ctx.state.params),
                    tst.tree_leaves(tctx.state.params)):
        assert torch.equal(a, b)
    for name in ('opt_state', 'pose_opt_state'):
        got, want = getattr(ctx.state, name), getattr(tctx.state, name)
        assert got.count == want.count == (6 if name == 'opt_state' else 2)
        assert torch.equal(got.mu, want.mu) and torch.equal(got.nu, want.nu)
    assert torch.equal(ctx.state.pose_grad_acc, tctx.state.pose_grad_acc)
    # finetune: the weights, with the step and both Adam states reset
    ctx = tloop.setup(_torch_args(targs, finetune=True), ds, device='cpu')
    assert ctx.start_step == 0 and ctx.state.step == 0
    assert ctx.state.opt_state.count == 0
    assert not ctx.state.opt_state.mu.any() \
        and not ctx.state.opt_state.nu.any()
    assert torch.equal(tst.flatten_tree(ctx.state.params),
                       tst.flatten_tree(tctx.state.params))


def test_pose_freeze_keeps_finetune_tau_and_rest_pose_idxs(
        h5, tmp_path, monkeypatch):
    """Two subjects under finetune, crossing opt_pose_stop at step 4: the
    port's rebuilt (pose-frozen) step keeps tau_fixed = 2000 and the
    subjects' rest_pose_idxs, both of which JAX's rebuild drops
    (ROADMAP Queue 3). JAX's frozen step then has no rest_pose_idxs for
    its two rest poses and fails to trace; its records up to the freeze
    equal the port's (the plain branch's 1e-5 relative)."""
    h5b = str(tmp_path / 'second_h5py.h5')
    make_synthetic_h5(h5b, n_kps=4, n_cams=2, H=32, W=32, seed=1)
    args = loop_args(tmp_path, h5, 'jax', subject=(h5, h5b), finetune=True)

    def subjects(concat, base, a):
        return concat([_surreal(base, p, a) for p in a.subject])

    state0 = _np(jloop.setup(args, subjects(
        JConcatH5Dataset, JSurrealDataset, args)).state)
    with pytest.raises(AssertionError, match='rest_pose_idxs'):
        jloop.train(args, subjects(JConcatH5Dataset, JSurrealDataset, args))

    made, taus = [], []
    make_step, derive = tloop._make_step, ttrainer.derive_schedules

    def spy_make_step(*a):
        made.append((a[6], a[7]))            # pose_frozen, step_kwargs
        return make_step(*a)

    def spy_derive(args_, cfg, step, tau_fixed=None):
        taus.append(tau_fixed)
        return derive(args_, cfg, step, tau_fixed)

    monkeypatch.setattr(tloop, '_make_step', spy_make_step)
    monkeypatch.setattr(ttrainer, 'derive_schedules', spy_derive)
    targs = _torch_args(args, expname='port')
    _seed_port(os.path.join(targs.basedir, targs.expname), state0)
    tctx = tloop.train(targs, subjects(ConcatH5Dataset, SurrealDataset,
                                       targs), device='cpu',
                       save_images=False)
    assert tctx.state.step == 6
    assert [frozen for frozen, _ in made] == [False, True]
    want_idxs = np.repeat([0, 1], 4)            # 4 poses per subject
    for _, kw in made:
        assert kw['tau_fixed'] == 2000.0
        np.testing.assert_array_equal(kw['rest_pose_idxs'].numpy(),
                                      want_idxs)
    assert taus == [2000.0] * 6                 # one per step
    got, want = _records(tctx.exp_dir), _records(
        os.path.join(args.basedir, args.expname))
    assert [r['step'] for r in got] == [2, 4, 6]
    assert [r['step'] for r in want] == [2, 4]
    assert all(np.isfinite(r['total_loss']) for r in got)
    for g, w in zip(got, want):
        for k in ('rgb_loss', 'rgb_loss0', 'kp_loss', 'total_loss'):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (g['step'], k)


def test_orbax_checkpoint_resumes_the_port_loop(plain_pair, tmp_path):
    """JAX's loop wrote orbax checkpoints (2, 4, 6): step 2, read through
    orbax and converted, resumes the port's loop at step 2."""
    args, state0, jctx, _, _ = plain_pair
    restored = jckpt.restore_checkpoint(
        jctx.exp_dir, jax.tree.map(jnp.asarray, state0), step=2)
    assert int(restored.step) == 2
    targs = _torch_args(args, basedir=str(tmp_path), expname='from_orbax')
    _seed_port(os.path.join(targs.basedir, targs.expname), restored, 2)
    ds = _surreal(SurrealDataset, args.subject[0], targs)
    ctx = tloop.setup(targs, ds, device='cpu')
    assert ctx.start_step == 2
    np.testing.assert_array_equal(tst.flatten_tree(ctx.state.params).numpy(),
                                  ravel_pytree(restored.params)[0])
    np.testing.assert_array_equal(ctx.state.opt_state.mu.numpy(),
                                  restored.opt_state[0].mu)
    ctx = tloop.train(targs, ds, device='cpu', save_images=False)
    assert ctx.state.step == 6
    steps = [r['step'] for r in _records(ctx.exp_dir)]
    assert steps == [4, 6]
    assert all(np.isfinite(r['total_loss']) for r in _records(ctx.exp_dir))


def test_restore_from_path_forms(plain_pair, tmp_path):
    args, _, _, tctx, _ = plain_pair
    targs = _torch_args(args, basedir=str(tmp_path), expname='ft',
                        no_reload=True)
    ds = _surreal(SurrealDataset, args.subject[0], targs)
    fresh = tloop.setup(targs, ds, device='cpu').state
    ckpts = os.path.join(tctx.exp_dir, 'checkpoints')
    want = tst.flatten_tree(tctx.state.params)
    for path, step in ((tctx.exp_dir, 6), (ckpts, 6),
                       (os.path.join(ckpts, '4'), 4)):
        got = tckpt.restore_from_path(path, fresh)
        assert got.step == step, path
        if step == 6:
            assert torch.equal(tst.flatten_tree(got.params), want)
        assert got.opt_state is fresh.opt_state     # weights only
        assert torch.equal(got.pose_params['bones'],
                           tckpt.restore_checkpoint(
                               tctx.exp_dir, fresh,
                               step=step).pose_params['bones'])
    with pytest.raises(NotImplementedError, match='Queue 1 item 6'):
        tckpt.restore_from_path(str(tmp_path / 'ref.tar'), fresh)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_from_path(str(tmp_path / 'nowhere'), fresh)
    # full wiring: setup(--ft_path --finetune) loads weights, resets step
    ctx = tloop.setup(_torch_args(targs, no_reload=False, finetune=True,
                                  ft_path=os.path.join(ckpts, '6')),
                      ds, device='cpu')
    assert ctx.start_step == 0
    assert torch.equal(tst.flatten_tree(ctx.state.params), want)


def test_checkpoint_round_trip_and_mismatch(tmp_path, h5):
    args = _torch_args(loop_args(tmp_path, h5, 'rt'))
    ds = _surreal(SurrealDataset, h5, args)
    state = tloop.setup(args, ds, device='cpu').state
    gen = torch.Generator().manual_seed(0)
    state = dataclasses.replace(
        state, step=9, pose_grad_acc=torch.randn(
            state.pose_grad_acc.shape, generator=gen),
        opt_state=tst.AdamState(3, torch.rand(state.opt_state.mu.shape,
                                              generator=gen),
                                torch.rand(state.opt_state.nu.shape,
                                           generator=gen)))
    for step in (1, 5, 9, 3):
        tckpt.save_checkpoint(args.basedir + '/rt', state, step)
    assert sorted(os.listdir(tmp_path / 'rt' / 'checkpoints'), key=int) \
        == ['3', '5', '9']
    back = tckpt.restore_checkpoint(str(tmp_path / 'rt'), state)
    assert back.step == 9 and back.opt_state.count == 3
    _same_tree(tckpt.state_tree(back), tckpt.state_tree(state))
    wide = tloop.setup(_torch_args(args, expname='wide', netwidth=64),
                       ds, device='cpu').state
    with pytest.raises(ValueError, match='shape'):
        tckpt.restore_checkpoint(str(tmp_path / 'rt'), wide)


def test_pose_snapshot_has_the_jax_format(tmp_path, plain_pair):
    """The port's .npz pose snapshot has JAX's key names and values, and
    each package's load_pose_checkpoint reads the other's."""
    state0 = plain_pair[1]
    jpath = jckpt.save_pose_checkpoint(str(tmp_path / 'j'),
                                       jax.tree.map(jnp.asarray, state0), 4)
    tpath = tckpt.save_pose_checkpoint(
        str(tmp_path / 't'), train_state_from_numpy(state0, 'cpu'), 4)
    jz, tz = np.load(jpath), np.load(tpath)
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        np.testing.assert_array_equal(jz[k], tz[k])
    back = tckpt.load_pose_checkpoint(jpath)
    np.testing.assert_array_equal(back['pose_params']['pelvis'],
                                  state0.pose_params['pelvis'])


def test_run_validation_matches_jax(h5, tmp_path):
    """One held-out render of 4 images from JAX's initial state through
    both packages' run_validation (the h5 dataset type: one framecode per
    image in both)."""
    args = loop_args(tmp_path, h5, 'jval')
    jds = JBaseH5Dataset(h5, N_samples=16, seed=1)
    jctx = jloop.setup(args, jds)
    want = jloop.run_validation(jctx, 40)
    targs = _torch_args(args, expname='tval')
    tctx = tloop.setup(targs, BaseH5Dataset(h5, N_samples=16, seed=1),
                       device='cpu')
    tctx.state = train_state_from_numpy(_np(jctx.state), 'cpu')
    assert tctx.val_bboxes is None
    got = tloop.run_validation(tctx, 40, save_images=True)
    assert tctx.val_bboxes.shape == (4, 2, 2)
    assert set(got) == set(want) == {'psnr', 'ssim', 'fg_psnr', 'fg_ssim'}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), \
            (k, got[k], want[k])
    val_dir = os.path.join(tctx.exp_dir, 'val', '00000040')
    assert sorted(os.listdir(val_dir)) == sorted(
        f'{kind}_{i:03d}.png' for kind in ('rgb', 'gt', 'disp', 'skel')
        for i in range(4))


def test_scan_step_matches_single_steps_and_jax():
    """make_train_step_scan on 3 stacked batches: bit for bit the single
    port step run 3 times, and JAX's scanned step within the bounds of
    tests/test_torch_train.py."""
    rng = np.random.default_rng(4)
    args, cfg, params, pose = build_tiny(
        rng, opt_pose=True, opt_rot6d=True, opt_pose_step=2,
        opt_pose_coef=2.0, opt_pose_tol=0.01)
    batches = [synthetic_batch(rng, pose, n_rays=16, n_images=4)
               for _ in range(3)]
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in batches]
    stacked = j_stack(batches)
    stacked['temp_val'] = None          # a None leaf stays None

    jcfg = cfg.test_mode()
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    opt = jst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                  args.lrate_decay_rate, args.decay_unit)
    popt = jst.make_pose_optimizer(args.opt_pose_lrate,
                                   args.opt_pose_lrate_decay,
                                   args.opt_pose_decay_rate,
                                   args.opt_pose_decay_unit)
    pose_params = jpose.init_pose_params(pose['kp3d'], pose['bones'], jpc)
    pos, acc = jst.init_pose_opt_state(popt, pose_params)
    jstate = jst.TrainState(
        step=jnp.int32(0), params=params,
        opt_state=jst.init_opt_state(opt, params), pose_params=pose_params,
        pose_opt_state=pos, pose_grad_acc=acc,
        anchors=jpose.pose_anchor_tree(pose['kp3d'], pose['bones']))
    state0 = _np(jstate)
    jfn = j_scan(args, jcfg, jpc, jnp.asarray(pose['rest_pose']), opt, popt,
                 unroll=3, tau_fixed=35.0, donate=False)
    jnew, jout = jfn(jstate, {k: None if v is None else jnp.asarray(v)
                              for k, v in stacked.items()},
                     jax.random.PRNGKey(0))

    targs = TrainConfig(**dataclasses.asdict(args))
    from anerf_torch.render.factory import build_render_config
    from anerf_torch.skeleton import SMPLSkeleton
    tcfg = build_render_config(targs, {'skel_type': SMPLSkeleton,
                                       'n_views': 8}).test_mode()
    topt = tst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                   args.lrate_decay_rate, args.decay_unit)
    tpopt = tst.make_pose_optimizer(args.opt_pose_lrate,
                                    args.opt_pose_lrate_decay,
                                    args.opt_pose_decay_rate,
                                    args.opt_pose_decay_unit)
    mk = dict(pose_cfg=tpose.PoseOptConfig(use_rot6d=True),
              rest_pose=torch.as_tensor(pose['rest_pose']),
              optimizer=topt, pose_optimizer=tpopt, tau_fixed=35.0)

    def to_torch(b):
        return {k: None if v is None else torch.as_tensor(
            v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in b.items()}
    scan = make_train_step_scan(targs, tcfg, unroll=3, **mk)
    new, out = scan(train_state_from_numpy(state0, 'cpu'),
                    to_torch(stacked), None)
    single = make_train_step(targs, tcfg, **mk)
    ref = train_state_from_numpy(state0, 'cpu')
    for b in batches:
        ref, ref_out = single(ref, to_torch(b), None)
    assert new.step == ref.step == 3
    _same_tree(tckpt.state_tree(new), tckpt.state_tree(ref))
    for grp in ('losses', 'stats'):
        for k, v in ref_out[grp].items():
            assert torch.equal(out[grp][k], v), k

    assert int(jnew.step) == 3
    for grp in ('losses', 'stats'):
        assert set(out[grp]) == set(jout[grp])
        for k, v in jout[grp].items():
            x, y = float(v), float(out[grp][k])
            if k == 'MPJPC':
                assert abs(x - y) < 1e-5, (k, x, y)
            else:
                assert abs(x - y) <= 1e-4 * max(abs(x), 1e-6), (k, x, y)
    assert _relmax(jnew.opt_state[0].mu, new.opt_state.mu.numpy()) < 2e-2
    assert _relmax(ravel_pytree(jnew.params)[0],
                   tst.flatten_tree(new.params).numpy()) < 1e-3
    assert _relmax(ravel_pytree(jnew.pose_params)[0],
                   tst.flatten_tree(new.pose_params).numpy()) < 1e-3


def test_stack_batches_keeps_none():
    bs = [{'a': np.full((2,), i), 'b': None} for i in range(3)]
    out = stack_batches(bs)
    assert out['b'] is None
    np.testing.assert_array_equal(out['a'], [[0, 0], [1, 1], [2, 2]])


def test_upload_batch_one_copy_views():
    batch = {'rays': np.arange(33, dtype=np.float32).reshape(3, 11),
             'pose_idx': np.array([0, 0, 1], np.int64),
             'fgs': np.ones((3, 1), np.float32), 'temp_val': None}
    out = tloop.upload_batch(batch, torch.device('cpu'))
    assert out['temp_val'] is None
    ptrs = set()
    for k in ('rays', 'pose_idx', 'fgs'):
        np.testing.assert_array_equal(out[k].numpy(), batch[k])
        assert out[k].dtype == torch.from_numpy(batch[k]).dtype
        ptrs.add(out[k].untyped_storage().data_ptr())
    assert len(ptrs) == 1                 # views of one buffer


def test_run_nerf_main_from_config_txt(tmp_path):
    """The counterpart of tests/test_run_nerf_cli.py through the port's
    run_nerf.main (on the CPU)."""
    h5 = str(tmp_path / 'syn_train_h5py.h5')
    make_synthetic_h5(h5, n_kps=4, n_cams=2, H=32, W=32)
    cfg_txt = tmp_path / 'exp.txt'
    cfg_txt.write_text(f"""
expname = cfg_exp
basedir = {tmp_path}
dataset_type = h5
subject = {h5}

bone_type = reldir
kp_dist_type = reldist
view_type = relray
use_cutoff = True
cutoff_viewdir = True
cutoff_inputs = True
use_viewdirs = True
use_background = True
opt_framecode = True

netdepth = 2
netwidth = 32
multires = 3
multires_views = 2
N_rand = 64
N_sample_images = 2
N_samples = 8
N_importance = 4
n_iters = 6
raw_noise_std = 1.0
chunk = 1024
compute_dtype = float32
scan_unroll = 3
i_print = 3
i_weights = 100000
i_testset = 100000
""")
    ctx = run_nerf_main(['--config', str(cfg_txt), '--seed', '1'],
                        device='cpu')
    assert ctx.args.expname == 'cfg_exp' and ctx.args.seed == 1
    assert ctx.state.step == 6
    assert os.path.exists(os.path.join(ctx.exp_dir, 'args.txt'))
    recs = _records(ctx.exp_dir)
    assert [r['step'] for r in recs] == [3, 6]
    assert all(np.isfinite(r['total_loss']) for r in recs)
