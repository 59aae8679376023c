"""anerf_torch train slice (train/, pose/, the schedules, the rotations the
step needs, train-state conversion) against anerf_tpu, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; JAX
states cross with train_state_from_numpy. The whole step runs in test
mode (perturb 0, no noise) on both render branches, the fused one
through K1 / K2's plain versions here and through the Pallas kernels in
interpret mode on the JAX side, against `make_train_step(raw=True)`
(jitted). The first Adam moment after one step is 0.1 g, so comparing
`mu` compares the gradients without Adam's sign-like first update.

Tolerances, each with what was observed:
  * whole step: losses and stats 1e-4 relative (observed <= 1.6e-5);
    MPJPC, a float-noise value near 0 here, 1e-5 absolute. mu of both
    optimizers 2e-2 relative max over the whole flat vector (observed
    7.5e-4 plain, 3.0e-3 fused). Both branches round activations to
    bf16, and the fused one can flip a ReLU mask where the JAX kernel
    rounds after another summation order (tests/test_torch_fused_bwd.py).
  * Adam, schedules, losses, rotations, FK: float32 round-off, 1e-5 to
    1e-6 relative (observed <= 1e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from anerf_tpu.ops import embedder as jemb
from anerf_tpu.ops import rotations as jrot
from anerf_tpu.pose import pose_opt as jpose
from anerf_tpu.train import losses as jloss
from anerf_tpu.train import state as jst
from anerf_tpu.train.trainer import make_train_step as j_make_train_step

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import (train_state_from_numpy,
                                 train_state_to_numpy)
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.ops import embedder as temb
from anerf_torch.ops import rotations as trot
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.render.factory import build_render_config
from anerf_torch.skeleton import SMPLSkeleton, smpl_rest_pose
from anerf_torch.train import losses as tloss
from anerf_torch.train import state as tst
from anerf_torch.train.loop import upload_batch
from anerf_torch.train.trainer import make_train_step, make_train_step_scan
from anerf_torch.utils import trace

from helpers import build_tiny, synthetic_batch


def _t(x):
    return torch.as_tensor(np.array(x))


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-7)


def _jax_state(args, params, pose=None, pose_cfg=None):
    """The JAX TrainState and optimizers of tests/test_train_step.py."""
    opt = jst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                  args.lrate_decay_rate, args.decay_unit)
    popt = pose_params = pose_opt_state = pose_acc = anchors = None
    if pose is not None:
        popt = jst.make_pose_optimizer(args.opt_pose_lrate,
                                       args.opt_pose_lrate_decay,
                                       args.opt_pose_decay_rate,
                                       args.opt_pose_decay_unit)
        pose_params = jpose.init_pose_params(pose['kp3d'], pose['bones'],
                                             pose_cfg)
        pose_opt_state, pose_acc = jst.init_pose_opt_state(popt, pose_params)
        anchors = jpose.pose_anchor_tree(pose['kp3d'], pose['bones'])
    state = jst.TrainState(step=jnp.int32(0), params=params,
                           opt_state=jst.init_opt_state(opt, params),
                           pose_params=pose_params,
                           pose_opt_state=pose_opt_state,
                           pose_grad_acc=pose_acc, anchors=anchors)
    return state, opt, popt


def _torch_optimizers(args, freeze_mask=None):
    opt = tst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                  args.lrate_decay_rate, args.decay_unit,
                                  freeze_mask=freeze_mask)
    popt = tst.make_pose_optimizer(args.opt_pose_lrate,
                                   args.opt_pose_lrate_decay,
                                   args.opt_pose_decay_rate,
                                   args.opt_pose_decay_unit)
    return opt, popt


def _torch_batch(batch):
    out = {k: _t(v) for k, v in batch.items()}
    for k in ('cam_idxs', 'pose_idx', 'kp_idxs'):
        out[k] = out[k].long()
    return out


def _torch_cfg(args, pose):
    return build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})


# ---------------------------------------------------------------- the step

@pytest.fixture(scope='module')
def flagship_step():
    """Flagship width (256 x 8, multires 7/4, bf16) with pose refinement
    (rot6d, opt_pose_step 2), 16 rays, 8 + 4 samples, density bias +2."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16', N_samples=8, N_importance=4,
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01)
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = (
            params[net]['alpha_linear']['b'] + 2.0)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    return args, cfg, params, pose, batch


@pytest.mark.parametrize('fused', [False, True])
def test_train_step_matches_jax(flagship_step, fused):
    args, cfg, params, pose, batch = flagship_step
    jcfg = dataclasses.replace(cfg.test_mode(), use_fused=fused)
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    jstate, opt, popt = _jax_state(args, params, pose, jpc)
    jstep = j_make_train_step(args, jcfg, jpc, jnp.asarray(pose['rest_pose']),
                              opt, popt, raw=True, tau_fixed=35.0)
    jnew, jout = jax.jit(jstep)(jstate, batch, jax.random.PRNGKey(0))

    tcfg = dataclasses.replace(_torch_cfg(args, pose).test_mode(),
                               use_fused=fused)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    topt, tpopt = _torch_optimizers(args)
    step = make_train_step(args, tcfg, tpose.PoseOptConfig(use_rot6d=True),
                           _t(pose['rest_pose']), topt, tpopt,
                           tau_fixed=35.0)
    before = (tfr.LAUNCHES, tfr.BWD_LAUNCHES)
    new, out = step(state, _torch_batch(batch), None)
    assert (tfr.LAUNCHES, tfr.BWD_LAUNCHES) == before   # plain on the CPU

    assert set(out['losses']) == set(jout['losses'])
    assert set(out['stats']) == set(jout['stats'])
    for grp in ('losses', 'stats'):
        for k, v in jout[grp].items():
            a, b = float(v), float(out[grp][k])
            if k == 'MPJPC':
                assert abs(a - b) < 1e-5, (k, a, b)
            else:
                assert abs(a - b) <= 1e-4 * max(abs(a), 1e-6), (k, a, b)
    assert new.step == 1 and new.opt_state.count == 1
    assert _relmax(jnew.opt_state[0].mu, new.opt_state.mu.numpy()) < 2e-2
    assert _relmax(jnew.pose_opt_state[0].mu,
                   new.pose_opt_state.mu.numpy()) < 2e-2
    assert np.abs(np.asarray(jnew.pose_opt_state[0].mu)).max() > 0
    # the stepped parameters land where JAX puts them
    assert _relmax(ravel_pytree(jnew.params)[0],
                   tst.flatten_tree(new.params).numpy()) < 1e-3


def test_train_spans_form_the_step_tree(flagship_step):
    """One fused dispatch of one step, fed by upload_batch, yields the
    train spans (utils/trace.py) in their tree: the upload a root of its
    own; the step under the dispatch; forward, backward and Adam under
    the step; each net's pack and K1 under the forward, its K2 under the
    backward."""
    args, cfg, params, pose, batch = flagship_step
    tcfg = dataclasses.replace(_torch_cfg(args, pose).test_mode(),
                               use_fused=True)
    jstate, _, _ = _jax_state(args, params, pose,
                              jpose.PoseOptConfig(use_rot6d=True))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    topt, tpopt = _torch_optimizers(args)
    step = make_train_step_scan(args, tcfg,
                                tpose.PoseOptConfig(use_rot6d=True),
                                _t(pose['rest_pose']), topt, tpopt,
                                tau_fixed=35.0, unroll=1)
    stacked = {k: v.numpy()[None] for k, v in _torch_batch(batch).items()}
    trace.take()
    trace.enable()
    try:
        step(state, upload_batch(stacked, torch.device('cpu')), None)
    finally:
        trace.disable()
    recs = trace.take()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert {k: len(v) for k, v in by.items()} == {
        'anerf.loop.upload': 1, 'anerf.train.dispatch': 1,
        'anerf.train.step': 1, 'anerf.train.forward': 1,
        'anerf.train.backward': 1, 'anerf.train.adam': 1,
        'anerf.fused.pack': 2, 'anerf.fused.k1': 2, 'anerf.fused.k2': 2}
    one = {k: v[0] for k, v in by.items()}
    up, disp = one['anerf.loop.upload'], one['anerf.train.dispatch']
    assert up.parent is None and disp.parent is None and up.root != disp.root
    parent = {'anerf.train.step': 'anerf.train.dispatch',
              'anerf.train.forward': 'anerf.train.step',
              'anerf.train.backward': 'anerf.train.step',
              'anerf.train.adam': 'anerf.train.step',
              'anerf.fused.pack': 'anerf.train.forward',
              'anerf.fused.k1': 'anerf.train.forward',
              'anerf.fused.k2': 'anerf.train.backward'}
    for name, above in parent.items():
        assert all(r.parent == one[above].id and r.root == disp.id
                   for r in by[name]), name
    assert disp.n == one['anerf.train.step'].n == 16
    assert sorted(r.n for r in by['anerf.fused.k1']) == \
        sorted(r.n for r in by['anerf.fused.k2'])
    assert min(r.n for r in by['anerf.fused.k1']) >= 16 * 4


def test_train_state_round_trip(flagship_step):
    args, _, params, pose, _ = flagship_step
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    jstate, _, _ = _jax_state(args, params, pose, jpc)
    jnp_state = jax.tree.map(np.asarray, jstate)
    state = train_state_from_numpy(jnp_state, 'cpu')
    back = train_state_to_numpy(state)
    assert back['step'] == 0 and back['opt_state']['count'] == 0
    for name in ('params', 'pose_params', 'pose_grad_acc', 'anchors'):
        want = getattr(jnp_state, name)
        assert jax.tree.structure(back[name]) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(back[name]), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    for name in ('opt_state', 'pose_opt_state'):
        adam = getattr(jnp_state, name)[0]
        np.testing.assert_array_equal(back[name]['mu'], adam.mu)
        np.testing.assert_array_equal(back[name]['nu'], adam.nu)
    again = train_state_to_numpy(train_state_from_numpy(back, 'cpu'))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ Adam and the state

@pytest.mark.parametrize('frozen', [False, True])
def test_flat_adam_matches_optax(frozen):
    rng = np.random.default_rng(3)
    n = 257
    p0 = rng.normal(size=n).astype(np.float32)
    grads = rng.normal(size=(5, n)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32) if frozen else None
    # lrate_decay 2, decay_unit 2: the rate changes within 5 steps
    jopt = jst.make_nerf_optimizer(1e-2, 2, 0.5, 2,
                                   freeze_mask=None if mask is None
                                   else jnp.asarray(mask))
    topt = tst.make_nerf_optimizer(1e-2, 2, 0.5, 2,
                                   freeze_mask=None if mask is None
                                   else _t(mask))
    jp, js = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    tp, ts = _t(p0), topt.init(_t(p0))
    for g in grads:
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        jp = jp + ju
        tu, ts = topt.update(_t(g), ts)
        tp = tp + tu
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                                   atol=1e-9)
    adam = js[0] if not frozen else js[0][0]
    assert ts.count == int(adam.count) == 5
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(adam.mu), rtol=1e-6)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(adam.nu), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_decay_schedule_matches_jax():
    jsched = jst.decay_schedule(5e-4, 250, 0.1, 1000)
    tsched = tst.decay_schedule(5e-4, 250, 0.1, 1000)
    for count in (0, 999, 1000, 123456, 250000):
        np.testing.assert_allclose(tsched(count),
                                   float(jsched(jnp.int32(count))),
                                   rtol=1e-6)


def test_flatten_order_freeze_mask_and_grad_norms_match_jax():
    rng = np.random.default_rng(0)
    _, _, params, _ = build_tiny(rng)
    tparams = jax.tree.map(lambda x: _t(x), params)
    flat, _ = ravel_pytree(params)
    np.testing.assert_array_equal(tst.flatten_tree(tparams).numpy(),
                                  np.asarray(flat))
    back = tst.unflatten_like(tst.flatten_tree(tparams), tparams)
    for a, b in zip(tst.tree_leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tst.freeze_mask_flat(tparams, 2).numpy(),
        np.asarray(jst.freeze_mask_flat(params, 2)))
    jt, ja = jst.grad_norms(params)
    tt, ta = tst.grad_norms(tparams)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


# ------------------------------------------------------------ small modules

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0.01, 0.99, size=(32, 3)).astype(np.float32)
    y = rng.uniform(size=(32, 3)).astype(np.float32)
    fg = (rng.uniform(size=(32,)) > 0.5).astype(np.float32)
    for red in ('mean', 'sum', 'none'):
        for name in ('MSE', 'L1', 'Huber'):
            np.testing.assert_allclose(
                tloss.get_loss_fn(name, 0.2)(_t(x), _t(y), red).numpy(),
                np.asarray(jloss.get_loss_fn(name, 0.2)(x, y, red)),
                rtol=1e-6)
    for red in ('mean', 'off'):
        np.testing.assert_allclose(
            tloss.acc2bce(_t(x[:, 0]), _t(fg), red).numpy(),
            np.asarray(jloss.acc2bce(x[:, 0], fg, red)), rtol=1e-6)
    np.testing.assert_allclose(tloss.img2psnr(_t(x), _t(y)).numpy(),
                               np.asarray(jloss.img2psnr(x, y)), rtol=1e-6)
    np.testing.assert_allclose(tloss.rgb_to_yuv(_t(x)).numpy(),
                               np.asarray(jloss.rgb_to_yuv(x)), rtol=1e-5,
                               atol=1e-6)
    assert tloss.get_reg_fn(None) is None
    assert tloss.get_reg_fn('BCE') is tloss.acc2bce


def test_rotations_match_jax():
    rng = np.random.default_rng(2)
    aa = (rng.normal(size=(64, 3)) * 1.2).astype(np.float32)
    aa[0] = 0.0                                   # the Taylor branches
    aa[1] = [np.pi - 1e-3, 0.0, 0.0]              # near pi: x-candidate
    rot = np.asarray(jrot.axisang_to_rot(jnp.asarray(aa)))
    r6 = np.asarray(jrot.rot_to_rot6d(jnp.asarray(rot)))
    pairs = [
        (trot.rot_to_rot6d(_t(rot)), r6),
        (trot.rot_to_quat(_t(rot)), jrot.rot_to_quat(jnp.asarray(rot))),
        (trot.rot_to_axisang(_t(rot)),
         jrot.rot_to_axisang(jnp.asarray(rot))),
        (trot.rot6d_to_axisang(_t(r6)),
         jrot.rot6d_to_axisang(jnp.asarray(r6))),
        (trot.axisang_to_quat(_t(aa)), jrot.axisang_to_quat(jnp.asarray(aa))),
        (trot.quat_to_axisang(trot.axisang_to_quat(_t(aa))),
         jrot.quat_to_axisang(jrot.axisang_to_quat(jnp.asarray(aa)))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-6)
    # round trip back to the axis-angle input (unique for angles < pi)
    ok = np.linalg.norm(aa, axis=-1) < np.pi - 0.1
    np.testing.assert_allclose(trot.rot_to_axisang(_t(rot)).numpy()[ok],
                               aa[ok], atol=2e-4)


def test_schedules_match_jax():
    cfg_t, _ = temb.make_embedder(7, 24, 0, {'cutoff': True, 'cutoff_dim': 24,
                                             'cutoff_inputs': True})
    cfg_j, _ = jemb.make_embedder(7, 24, 0, {'cutoff': True, 'cutoff_dim': 24,
                                             'cutoff_inputs': True})
    for step in (0, 1000, 12345, 250000, 10 ** 7):
        np.testing.assert_allclose(
            temb.tau_schedule(cfg_t, step, 250, 10.0),
            float(jemb.tau_schedule(cfg_j, jnp.int32(step), 250, 10.0)),
            rtol=1e-6)
        np.testing.assert_allclose(
            temb.alpha_schedule(cfg_t, step, 5),
            float(jemb.alpha_schedule(cfg_j, jnp.int32(step), 5)),
            rtol=1e-6)
    assert temb.tau_schedule(cfg_t, 10 ** 9, 250, 10.0) == 2000.0


@pytest.mark.parametrize('rot6d,shared', [(False, False), (True, False),
                                          (True, True)])
def test_fk_lookup_values_and_grads_match_jax(rot6d, shared):
    rng = np.random.default_rng(4)
    n = 6
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n, 24, 3)) * 0.3).astype(np.float32)
    kp3d = rng.normal(size=(n, 24, 3)).astype(np.float32)
    kp_map = np.array([0, 1, 0, 2, 1, 2]) if shared else None
    kp_uidxs = np.array([0, 1, 3]) if shared else None
    idxs = np.array([4, 1, 3])
    jc = jpose.PoseOptConfig(use_rot6d=rot6d)
    tc = tpose.PoseOptConfig(use_rot6d=rot6d)
    jp = jpose.init_pose_params(kp3d, bones, jc, kp_map, kp_uidxs)
    tp = tpose.init_pose_params(kp3d, bones, tc, kp_map, kp_uidxs, 'cpu')
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((3, 24, 3), (3, 24, 4, 4))]

    def jf(p):
        k, _, sk, _, _ = jpose.fk_lookup(
            p, jnp.asarray(idxs), jnp.asarray(rest)[None], jc,
            None if kp_map is None else jnp.asarray(kp_map))
        return jnp.sum(k * w[0]) + jnp.sum(sk * w[1]), (k, sk)

    (jl, (jk, jsk)), jg = jax.value_and_grad(jf, has_aux=True)(jp)
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tk, _, tsk, _, _ = tpose.fk_lookup(
        tp, _t(idxs).long(), _t(rest)[None], tc,
        None if kp_map is None else _t(kp_map).long())
    (torch.sum(tk * _t(w[0])) + torch.sum(tsk * _t(w[1]))).backward()
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsk.detach().numpy(), np.asarray(jsk),
                               rtol=1e-5, atol=1e-5)
    assert set(tp) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------- the step rules, port alone

def _port_setup(seed=0, **overrides):
    """A tiny plain-branch setup (width 32, float32) built the way
    tests/test_train_step.py builds it, carried into the port."""
    rng = np.random.default_rng(seed)
    args, _, params, pose = build_tiny(rng, **overrides)
    tcfg = _torch_cfg(args, pose)
    pose_cfg = tpose.PoseOptConfig(use_rot6d=args.opt_rot6d) \
        if args.opt_pose else None
    jstate, _, _ = _jax_state(
        args, params, pose if args.opt_pose else None,
        jpose.PoseOptConfig(use_rot6d=args.opt_rot6d))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    batch = _torch_batch(synthetic_batch(rng, pose))
    return args, tcfg, state, pose_cfg, _t(pose['rest_pose']), batch


def _run(args, tcfg, state, pose_cfg, rest, batch, n, **kw):
    opt, popt = _torch_optimizers(args, kw.pop('freeze_mask', None))
    step = make_train_step(args, tcfg, pose_cfg, rest, opt, popt, **kw)
    gen = torch.Generator().manual_seed(0)
    states, outs = [state], []
    for _ in range(n):
        state, out = step(state, batch, gen)
        states.append(state)
        outs.append(out)
    return states, outs


def test_train_step_decreases_loss():
    args, tcfg, state, _, _, batch = _port_setup()
    batch['target_s'] = torch.full_like(batch['target_s'], 0.3)
    states, outs = _run(args, tcfg, state, None, None, batch, 30)
    losses = [float(o['losses']['total_loss']) for o in outs]
    assert states[-1].step == 30
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1e-3, losses


def test_train_step_pose_interval():
    args, tcfg, state, pose_cfg, rest, batch = _port_setup(
        opt_pose=True, opt_pose_step=4, opt_pose_coef=0.5,
        opt_pose_lrate=1e-3, use_temp_loss=True, temp_coef=0.01)
    pelvis0 = state.pose_params['pelvis'].clone()
    states, outs = _run(args, tcfg, state, pose_cfg, rest, batch, 6)
    assert 'kp_loss' in outs[-1]['losses']
    assert 'temp_loss' in outs[-1]['losses']
    assert 'MPJPC' in outs[-1]['stats']
    p = [s.pose_params['pelvis'] for s in states]
    assert not torch.allclose(p[0], p[1])      # step 0 steps
    assert torch.equal(p[1], p[2])             # step 1 accumulates
    assert not torch.allclose(p[2], p[5])      # step 4 steps
    assert states[2].pose_grad_acc.abs().max() > 0
    assert not states[5].pose_grad_acc.any()
    untouched = np.setdiff1d(np.arange(len(pelvis0)),
                             batch['kp_idxs'].numpy())
    assert torch.equal(p[5][untouched], pelvis0[untouched])


def test_train_step_pose_warmup():
    args, tcfg, state, pose_cfg, rest, batch = _port_setup(
        opt_pose=True, opt_pose_step=2, opt_pose_warmup=4,
        opt_pose_lrate=1e-3)
    p0 = state.pose_params['pelvis'].clone()
    states, _ = _run(args, tcfg, state, pose_cfg, rest, batch, 7)
    for k in range(1, 5):              # steps 0-3: frozen, grads dropped
        assert torch.equal(states[k].pose_params['pelvis'], p0)
        assert not states[k].pose_grad_acc.any()
        assert states[k].pose_opt_state.count == 0
    assert not torch.allclose(states[5].pose_params['pelvis'], p0)


def test_train_step_pose_frozen():
    args, tcfg, state, pose_cfg, rest, batch = _port_setup(
        opt_pose=True, opt_pose_step=1)
    p0 = state.pose_params['pelvis'].clone()
    states, outs = _run(args, tcfg, state, pose_cfg, rest, batch, 1,
                        pose_frozen=True)
    assert torch.equal(states[1].pose_params['pelvis'], p0)
    assert 'kp_loss' not in outs[0]['losses']


def test_cutoff_dist_not_trained():
    args, tcfg, state, _, _, batch = _port_setup()
    c0 = state.params['cutoff_dist'].clone()
    states, _ = _run(args, tcfg, state, None, None, batch, 2)
    assert torch.equal(states[-1].params['cutoff_dist'], c0)
    # its optimizer moments stay zero: the step zeroes its gradient
    n_coarse = sum(x.numel() for x in tst.tree_leaves(state.params['coarse']))
    assert not states[-1].opt_state.mu[n_coarse:n_coarse + c0.numel()].any()


def test_fix_layer_freezes_trunk():
    args, tcfg, state, _, _, batch = _port_setup(raw_noise_std=1.0)
    mask = tst.freeze_mask_flat(state.params, 2)
    p0 = tst.flatten_tree(state.params).clone()
    states, _ = _run(args, tcfg, state, None, None, batch, 3,
                     freeze_mask=mask)
    p1 = states[-1].params
    p0 = tst.unflatten_like(p0, state.params)
    for net in ('coarse', 'fine'):
        for i in range(2):
            assert torch.equal(p1[net]['pts_linears'][i]['w'],
                               p0[net]['pts_linears'][i]['w'])
        assert not torch.equal(p1[net]['pts_linears'][2]['w'],
                               p0[net]['pts_linears'][2]['w'])
        assert not torch.equal(p1[net]['rgb_linear']['w'],
                               p0[net]['rgb_linear']['w'])
