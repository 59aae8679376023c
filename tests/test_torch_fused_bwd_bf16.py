"""K2's bf16-cotangent flavour (fused_bwd / fused_apply with
bwd_f32=False, the --fast_grads numerics), the render path's backward
knobs, and the culled fast-grads train step, against anerf_tpu on the
CPU.

On a CPU tensor `fused_bwd` runs its plain PyTorch version, so these
tests hold the plain version's bf16 flavour (`fused_bwd_ref(...,
bwd_f32=False)`) to the JAX `fused_apply` VJP with bwd_f32=False (the
Pallas backward kernel in interpret mode, as tests/test_fused_render.py
runs it), and to the JAX kernel's rounding rules written with jax.numpy
on the port's own forward trace. The CUDA kernel is held to the plain
version on the card (chip_smoke.py, tests/test_torch_kernels_gpu.py).

Tolerances, each with what was observed (setup of
tests/test_torch_fused_bwd.py: width 256, depth 8, 16 rays x 6 samples):
  * against the JAX VJP: pts, skts and framecodes 2e-2 relative max;
    each parameter leaf 2e-2 relative in the Frobenius norm and 0.12
    relative max, the bounds of the f32 flavour's test (observed <= 1.4e-2
    on the inputs, <= 1.2e-2 / 0.05 on the leaves). The forwards round
    activations to bf16 after f32 sums in another order (and the JAX
    kernel's sin / cos is a polynomial), which flips an occasional ReLU
    mask or bf16 rounding. That noise is larger than the flavours' own
    difference, so the next test holds the rounding rules.
  * against the JAX rounding rules on the same trace: 2e-3 relative in the
    Frobenius norm per dW block and per input cotangent (observed <=
    3.8e-4: the two sum in another f32 order, which flips an occasional
    bf16 rounding of a cotangent, and the depth carries it on). Leaving g
    unrounded in the heads or in the alpha head's term reads >= 7.4e-3,
    and the f32 flavour >= 5.8e-3, so the bound sees either.
  * the flavours apart: the bf16 flavour differs from the f32 one by more
    than 1e-4 relative (Frobenius) in every dW block and input cotangent
    (observed >= 7.5e-4), and the heads' bias rows, sums of the unrounded
    g, are equal bit for bit.
  * whole culled fast-grads step (fused branch): losses and stats 1e-4
    relative, MPJPC 1e-5 absolute (observed <= 2.8e-5 relative, 6.1e-8
    absolute); mu of both optimizers 2e-2 relative max (observed <=
    1.5e-3); the stepped parameters 1e-3 (observed 4.7e-4): the f32
    step's bounds (tests/test_torch_train.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from anerf_tpu.pose import pose_opt as jpose
from anerf_tpu.render.raycaster import render_rays as j_render_rays
from anerf_tpu.train.trainer import make_train_step as j_make_train_step

from anerf_torch.convert import params_from_numpy, train_state_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.render.raycaster import render_rays
from anerf_torch.train import state as tst
from anerf_torch.train.trainer import make_train_step

from helpers import build_tiny, synthetic_batch
from test_torch_fused_bwd import (R, S, _jax_grads, _relfro, _relmax, _t,
                                  _torch_grads, make_setup)
from test_torch_train import (_jax_state, _torch_batch, _torch_cfg,
                              _torch_optimizers)

RULES_FRO = 2e-3


@pytest.fixture(scope='module')
def setup():
    """tests/test_torch_fused_bwd.py's setup, with the coarse net's
    kernel operands packed."""
    s = make_setup()
    s['packed'] = tfr.pack_render_params(s['tparams']['coarse'],
                                         s['tcfg'].nerf, 7, 4,
                                         s['tparams']['cutoff_dist'])
    fc = s['tparams']['coarse']['framecodes']['codes'][
        _t(s['batch']['cam_idxs']).long()]
    s['m_all'], s['aux'] = tfr.pack_ray_data(_t(s['rays_d'])[:, None],
                                             _t(s['skts']), fc)
    return s


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_fused_bwd_bf16_matches_jax_vjp(setup, tau):
    s = setup
    jg = _jax_grads(s, tau, bwd_f32=False)
    leaves, dpts, dskts, dcodes = _torch_grads(s, tau, bwd_f32=False)
    jleaves = tfr._net_leaves(s['tcfg'].nerf,
                              jax.tree.map(np.asarray, jg[0]))
    assert len(jleaves) == len(leaves) == 2 * (8 + 4)
    for i, (a, b) in enumerate(zip(jleaves, leaves)):
        assert a.shape == tuple(b.shape), i
        assert _relfro(a, b.numpy()) < 2e-2, (i, _relfro(a, b.numpy()))
        assert _relmax(a, b.numpy()) < 0.12, (i, _relmax(a, b.numpy()))
    assert _relmax(jg[1], dpts.numpy()) < 2e-2
    assert _relmax(jg[2], dskts.numpy()) < 2e-2
    assert _relmax(jg[3], dcodes.numpy()) < 2e-2


def _jax_rules_mlp_bwd(ncfg, t, g, k0p):
    """The MLP backward of the JAX kernel's bwd_f32=False flavour
    (anerf_tpu/kernels/fused_render.py: _render_kernel_pts_bwd, mmT / mmO
    cast both operands to bf16 and sum in f32; biases are f32 sums of the
    unrounded cotangents), written with jax.numpy on the port's forward
    trace `t` (f32 arrays of bf16 values; weights (N, K)). Returns
    ({block: (K + 1, N)}, dx0, dxv)."""
    bf, f32 = jnp.bfloat16, jnp.float32
    mm = lambda a, b: jnp.matmul(a.astype(bf), b.astype(bf),
                                 preferred_element_type=f32)
    block = lambda x, dy: jnp.concatenate(
        [mm(x.T, dy), jnp.sum(dy, 0, keepdims=True)])
    P = g.shape[0]
    flat = lambda x: jnp.asarray(x.numpy()).reshape(P, x.shape[-1])
    x0, xv, feat, hv = (flat(t[k]) for k in ('x0', 'xv', 'feat', 'hv'))
    hs = [flat(h) for h in t['hs']]
    ws = [jnp.asarray(w.numpy()) for w in t['ws']]
    w_rgb, w_alpha = (jnp.asarray(t['packed'][k].numpy())
                      for k in ('w_rgb', 'w_alpha'))
    W, depth = ncfg.width, ncfg.depth
    out = {'rgb': block(hv, g[:, :3]), 'alpha': block(hs[-1], g[:, 3:])}
    dhv = mm(g[:, :3], w_rgb) * (hv > 0)
    out['view'] = block(jnp.concatenate([feat, xv], -1), dhv)
    dview = mm(dhv, ws[depth + 1])
    dfeat, dxv = dview[:, :W], dview[:, W:]
    out['feat'] = block(hs[-1], dfeat)
    dh = (mm(dfeat, ws[depth]) + mm(g[:, 3:], w_alpha[None])) * (hs[-1] > 0)
    dx0 = jnp.zeros_like(x0)
    for i in range(depth - 1, 0, -1):
        skip = (i - 1) in ncfg.skips
        out[f'l{i}'] = block(jnp.concatenate([x0, hs[i - 1]], -1) if skip
                             else hs[i - 1], dh)
        din = mm(dh, ws[i])
        if skip:
            dx0, din = dx0 + din[:, :k0p], din[:, k0p:]
        dh = din * (hs[i - 1] > 0)
    out['l0'] = block(x0, dh)
    return out, dx0 + mm(dh, ws[0]), dxv


@pytest.mark.parametrize('g_mask', ['all', 'rgb_only', 'alpha_only'])
def test_bf16_flavour_follows_jax_rounding_rules(setup, g_mask):
    """g in the rgb channels only exercises the heads and dhv; in the alpha
    channel only, the alpha head's term of the last trunk cotangent."""
    s = setup
    ncfg, packed = s['tcfg'].nerf, s['packed']
    g = s['gw'].copy()
    if g_mask == 'rgb_only':
        g[..., 3] = 0.0
    elif g_mask == 'alpha_only':
        g[..., :3] = 0.0
    args = (ncfg, packed, _t(s['pts']), s['m_all'], s['aux'], S, 35.0,
            _t(g))
    dW, dx0, dxv = tfr.mlp_bwd_ref(*args, bwd_f32=False)
    t = tfr._forward_trace(*args[:7])
    t['packed'] = packed
    _, k0p, _, _ = tfr.input_widths(7, 4)
    want, wdx0, wdxv = _jax_rules_mlp_bwd(ncfg, t, jnp.asarray(
        g.reshape(-1, 4)), k0p)
    got = tfr.split_grads(ncfg, 7, 4, dW)
    for name, w in want.items():
        w = np.asarray(w)
        if not np.any(w):
            assert not got[name].any(), name
            continue
        assert _relfro(w, got[name].numpy()) < RULES_FRO, name
    assert _relfro(np.asarray(wdx0), dx0.reshape(-1, k0p).numpy()) \
        < RULES_FRO
    assert _relfro(np.asarray(wdxv), dxv.reshape(R * S, -1).numpy()) \
        < RULES_FRO


def test_bf16_flavour_differs_from_f32_and_keeps_head_bias_rows(setup):
    s = setup
    ncfg = s['tcfg'].nerf
    args = (ncfg, s['packed'], _t(s['pts']), s['m_all'], s['aux'], S,
            35.0, _t(s['gw']))
    f32 = tfr.fused_bwd_ref(*args)
    bf = tfr.fused_bwd_ref(*args, bwd_f32=False)
    b32 = tfr.split_grads(ncfg, 7, 4, f32[0])
    b16 = tfr.split_grads(ncfg, 7, 4, bf[0])
    for name in b32:
        if name in ('rgb', 'alpha'):
            # bias rows: sums of the unrounded g in both flavours
            assert torch.equal(b32[name][-1], b16[name][-1])
            g = _t(s['gw']).reshape(-1, 4)
            g = g[:, :3] if name == 'rgb' else g[:, 3:]
            torch.testing.assert_close(b16[name][-1], g.sum(0))
        assert _relfro(b32[name].numpy(), b16[name].numpy()) > 1e-4, name
    for a, b in zip(f32[1:], bf[1:]):
        assert _relfro(a.numpy(), b.numpy()) > 1e-4
    # the wrapper takes the plain version on the CPU and passes the flag
    before = (tfr.BWD_LAUNCHES, tfr.BWD_BF16_LAUNCHES)
    got = tfr.fused_bwd(*args, bwd_f32=False)
    assert (tfr.BWD_LAUNCHES, tfr.BWD_BF16_LAUNCHES) == before == (0, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, bf))


def test_trace_from_act_gives_the_plain_backward(setup):
    """The plain backward on activations laid out as K2 saves them
    (`act_image`) is the plain backward on its own recompute: the input
    cotangents bit for bit, dW to f32 summation order (the slices are
    strided), in both flavours."""
    s = setup
    ncfg = s['tcfg'].nerf
    args = (ncfg, s['packed'], _t(s['pts']), s['m_all'], s['aux'], S,
            35.0, _t(s['gw']))
    t = tfr._forward_trace(*args[:7])
    rows = tfr.act_rows(ncfg, 7, 4)
    P, W = R * S, ncfg.width
    a = torch.zeros(P, rows['F'])
    flat = lambda x: x.reshape(P, -1)
    a[:, :t['x0'].shape[-1]] = flat(t['x0'])
    a[:, rows['xv']:rows['xv'] + t['xv'].shape[-1]] = flat(t['xv'])
    for i, h in enumerate(t['hs']):
        a[:, rows['h'] + i * W:rows['h'] + (i + 1) * W] = flat(h)
    a[:, rows['feat']:rows['feat'] + W] = flat(t['feat'])
    a[:, rows['hv']:rows['hv'] + W // 2] = flat(t['hv'])
    trace = tfr.trace_from_act(ncfg, s['packed'],
                               tfr.act_image(a.to(torch.bfloat16)), P)
    for flag in (True, False):
        want = tfr.mlp_bwd_ref(*args, bwd_f32=flag)
        got = tfr.mlp_bwd_ref(*args, bwd_f32=flag, trace=trace)
        assert _relfro(want[0].numpy(), got[0].numpy()) < 1e-7
        assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])


def test_fused_apply_passes_bwd_f32_to_k2(setup):
    """fused_apply's gradients are K2's plain version in the flavour asked
    for, mapped onto the parameter leaves."""
    s = setup
    for flag in (True, False):
        leaves = _torch_grads(s, 35.0, bwd_f32=flag)[0]
        net = s['tparams']['coarse']
        fc = net['framecodes']['codes'][_t(s['batch']['cam_idxs']).long()]
        m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None],
                                       _t(s['skts']), fc)
        dW = tfr.fused_bwd_ref(s['tcfg'].nerf, s['packed'], _t(s['pts']),
                               m_all, aux, S, 35.0, _t(s['gw']), flag)[0]
        want = tfr._leaf_grads(s['tcfg'].nerf, 7, 4, dW)
        assert all(torch.equal(a, b) for a, b in zip(leaves, want))


# ------------------------------------------------ the render path's knobs

KNOBS = ('fast_grads', 'fast_pe', 'fast_mlp', 'alpha_f32', 'hifi_pe',
         'sr_grads')


def _knob_setup(knob, fused, value=True, width=256, depth=8):
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=width, netwidth_fine=width, netdepth=depth,
        multires=7, multires_views=4, compute_dtype='bfloat16', N_samples=8,
        N_importance=4)
    tcfg = dataclasses.replace(_torch_cfg(args, pose).test_mode(),
                               use_fused=fused, **{knob: value})
    jcfg = dataclasses.replace(cfg.test_mode(), use_fused=fused,
                               **{knob: value})
    batch = synthetic_batch(rng, pose, n_rays=8, n_images=4)
    return jcfg, tcfg, params, batch


def _knob_render(knob, fused, value=True, width=256, depth=8):
    """render_rays in test mode with `knob` set, on a small batch
    (flagship width unless asked) with gradients on; returns the coarse
    net's leaf gradients of sum(rgb) + sum(rgb0)."""
    _, tcfg, params, batch = _knob_setup(knob, fused, value, width, depth)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    leaves = tfr._net_leaves(tcfg.nerf, tparams['coarse'])
    for x in leaves:
        x.requires_grad_(True)
    pr = lambda k: _t(batch[k][batch['pose_idx']])
    out = render_rays(tparams, tcfg, _t(batch['rays']), pr('kp3d'),
                      pr('skts'), pr('bones'), pr('cyls'),
                      cam_idxs=_t(batch['cam_idxs']).long(), tau=35.0)
    return torch.autograd.grad(out['rgb_map'].sum() + out['rgb0'].sum(),
                               leaves)


@pytest.mark.parametrize('knob', KNOBS)
def test_plain_branch_knob_matches_jax(knob):
    """The plain branch with each backward knob (64 wide, 4 deep) against
    JAX's render_rays with the same knob: the coarse net's leaf gradients
    within 2e-2 relative to each leaf's largest value (the whole step's
    bound, tests/test_torch_train.py; observed <= 5.6e-3: a bf16 rounding
    flipped by the summation order moves an entry near the largest by a
    bf16 step). Without an rng both packages run sr_grads' deterministic path, as a
    render does."""
    jcfg, _, params, batch = _knob_setup(knob, False, width=64, depth=4)
    got = _knob_render(knob, False, width=64, depth=4)

    def loss(coarse):
        p = dict(params, coarse=coarse)
        pr = lambda k: batch[k][batch['pose_idx']]
        out = j_render_rays(p, jcfg, batch['rays'], pr('kp3d'), pr('skts'),
                            pr('bones'), pr('cyls'),
                            cam_idxs=batch['cam_idxs'],
                            tau=jnp.float32(35.0))
        return out['rgb_map'].sum() + out['rgb0'].sum()
    want = tfr._net_leaves(jcfg.nerf, jax.jit(jax.grad(loss))(
        params['coarse']))
    assert any(float(jnp.abs(w).max()) > 0 for w in want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _relmax(a.numpy(), np.asarray(b)) < 2e-2, (knob, i)


@pytest.mark.parametrize('knob', KNOBS)
def test_fused_branch_accepts_backward_knob(knob):
    """As in JAX, the fused branch reads only the MLP fast-grads knob
    (eff_fast_mlp: K2's bf16 flavour); the others leave its gradients
    as they are."""
    got = _knob_render(knob, fused=True)
    base = _knob_render(knob, fused=True, value=False)
    assert all(torch.isfinite(g).all() for g in got)
    same = all(torch.equal(a, b) for a, b in zip(got, base))
    assert same == (knob not in ('fast_grads', 'fast_mlp')), knob


def test_plain_branch_accepts_remat_pe():
    """remat_pe changes what JAX keeps for the backward, not the values."""
    got = _knob_render('remat_pe', fused=False)
    base = _knob_render('remat_pe', fused=False, value=False)
    assert all(torch.equal(a, b) for a, b in zip(got, base))


# ------------------------------------------ the culled fast-grads step

def test_culled_fast_grads_train_step_matches_jax():
    """Flagship width with pose refinement, 64 + 16 samples culled at
    0.125 (the coarse net at S = 8, the fine net at 8 + 16 = 24),
    fast_grads and the fused kernel: one step in test mode against
    make_train_step(raw=True)."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16', N_samples=64, N_importance=16,
        cull_ratio=0.125, fast_grads=True, fused_kernel=True,
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01)
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = (
            params[net]['alpha_linear']['b'] + 2.0)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    jcfg = cfg.test_mode()
    assert jcfg.use_fused and jcfg.eff_fast_mlp and jcfg.n_keep == 8
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    jstate, opt, popt = _jax_state(args, params, pose, jpc)
    jstep = j_make_train_step(args, jcfg, jpc, jnp.asarray(pose['rest_pose']),
                              opt, popt, raw=True, tau_fixed=35.0)
    jnew, jout = jax.jit(jstep)(jstate, batch, jax.random.PRNGKey(0))

    tcfg = _torch_cfg(args, pose).test_mode()
    assert tcfg.use_fused and tcfg.eff_fast_mlp and tcfg.n_keep == 8
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    topt, tpopt = _torch_optimizers(args)
    step = make_train_step(args, tcfg, tpose.PoseOptConfig(use_rot6d=True),
                           _t(pose['rest_pose']), topt, tpopt,
                           tau_fixed=35.0)
    calls = []
    real = tfr.fused_bwd_ref

    def spy(*a, **kw):
        calls.append((a[5], a[-1] if len(a) > 8 else kw.get('bwd_f32')))
        return real(*a, **kw)

    tfr.fused_bwd_ref = spy
    try:
        new, out = step(state, _torch_batch(batch), None)
    finally:
        tfr.fused_bwd_ref = real
    # K2's plain version ran twice, in the bf16 flavour, at S = 8 and 24
    assert sorted(calls) == [(8, False), (24, False)]

    for grp in ('losses', 'stats'):
        assert set(out[grp]) == set(jout[grp])
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
    assert _relmax(ravel_pytree(jnew.params)[0],
                   tst.flatten_tree(new.params).numpy()) < 1e-3
