"""The plain branch's numerics knobs (fast_grads / fast_mlp, alpha_f32,
sr_grads, fast_pe, hifi_pe, remat_pe) against anerf_tpu with the same
knob, on the CPU.

Inputs come from numpy's default_rng; the MLPs are 64 wide and 4 deep.
Tolerances, each with what was observed:
  * the SR hash: `_sr_noise_bits` and `_sr_cast` equal JAX's bit for bit
    on the same uint32 key words.
  * SR unbiasedness (port only, JAX's own test's bounds,
    tests/test_sr_grads.py): representable values pass through every
    key; the mean over 2048 keys within 0.1 bf16 ulp; key-averaged SR
    weight gradients nearer the f32 ones than one draw and within
    2.5e-2 of the largest.
  * a dense layer and the MLP in bf16, relative to each output's or
    leaf's largest value: the forward within 1e-6 (observed 3e-7: the
    same bf16 product, f32 sums in another order); bf16-cotangent
    gradients within 5e-3, one bf16 step (2^-8) of the largest value,
    which an occasional rounding flipped by the summation order stays
    under (observed 3.1e-7); the SR twin's gradients, a draw of their
    own, within 2e-2 of JAX's (observed 4.4e-3).
  * the PE, relative to each gradient's largest value: bf16 emission
    (fast_pe) within 2e-2 (observed 5.7e-3: the backward's bf16 sums
    round once in torch, where XLA may round per step; the forwards
    are bit-equal, held to 1e-2 absolute); hifi_pe's bf16 backward
    within 5e-3 (observed 2.7e-7); remat_pe's f32 backward within 1e-5
    (observed 3.8e-7). hifi / remat forwards torch.equal to the default
    chain followed by the cast (JAX's tests/test_embedder.py:187);
    remat's gradients within 1e-5 of autograd's through the default
    chain (observed 1.8e-7: the same f32 math in another order).
  * the whole step against make_train_step(raw=True): losses 1e-4
    relative, Adam's first moment 2e-2 relative over the flat vector
    (tests/test_torch_train.py's bounds; observed 6.8e-4 to 3.9e-3, SR
    5.6e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from anerf_tpu.models import nerf as jnerf
from anerf_tpu.ops import embedder as jemb
from anerf_tpu.pose import pose_opt as jpose
from anerf_tpu.train import state as jst
from anerf_tpu.train.trainer import make_train_step as j_make_train_step

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy, train_state_from_numpy
from anerf_torch.models import nerf as tnerf
from anerf_torch.ops import embedder as temb
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.render.factory import build_render_config
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.train import state as tst
from anerf_torch.train.trainer import make_train_step

from helpers import build_tiny, synthetic_batch

BF16 = torch.bfloat16


def _t(x):
    return torch.as_tensor(np.array(x))


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- the SR hash

KEY_WORDS = [(0, 0), (3, 12345), (0xFFFFFFFF, 0x9E3779B9)]


@pytest.mark.parametrize('words', KEY_WORDS)
def test_sr_hash_and_cast_bit_equal_jax(words):
    kd = np.array(words, np.uint32)
    tkey = torch.as_tensor(kd.view(np.int32))
    got = tnerf._sr_noise_bits(tkey, (33, 65)).numpy()
    want = np.asarray(jnerf._sr_noise_bits(jnp.asarray(kd), (33, 65)))
    np.testing.assert_array_equal(got, want.astype(np.int32))
    x = (np.random.default_rng(1).normal(size=(33, 65)) * 30).astype(
        np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, 2.0 ** -64]
    got = tnerf._sr_cast(_t(x), tkey).float().numpy().view(np.uint32)
    want = np.asarray(jnerf._sr_cast(jnp.asarray(x), jnp.asarray(kd)),
                      np.float32).view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_sr_cast_unbiased_and_exact_on_representables():
    gen = torch.Generator().manual_seed(0)
    exact = torch.tensor([0.0, -0.0, 1.0, -2.5, 0.15625, 2.0 ** -64])
    for _ in range(4):
        assert torch.equal(tnerf._sr_cast(exact, tnerf.sr_salt(gen)).float(),
                           exact)
    x = torch.tensor(np.linspace(1.0, 2.0, 257)[1:-1], dtype=torch.float32)
    n_keys = 2048
    acc = torch.zeros(x.shape, dtype=torch.float64)
    for _ in range(n_keys):
        acc += tnerf._sr_cast(x, tnerf.sr_salt(gen)).double()
    ulp = 2.0 ** -8
    assert (acc / n_keys - x.double()).abs().max().item() < 0.1 * ulp
    one = tnerf._sr_cast(x, tnerf.sr_salt(gen)).float()
    lo = x.to(BF16).float()
    assert bool(((one == lo) | ((one - lo).abs() <= 2 * ulp)).all())


def test_sr_keys_are_distinct():
    """fold_in / key_split give a different key per layer and site."""
    key = tnerf.sr_salt(torch.Generator().manual_seed(3))
    keys = [tnerf.fold_in(key, i) for i in (0, 1, 2, 100, 150, 200, 201)]
    keys += list(tnerf.key_split(key))
    words = {tuple(k.tolist()) for k in keys}
    assert len(words) == len(keys)
    assert all(k.dtype == torch.int32 and k.shape == (2,) for k in keys)


def test_sr_grad_expectation_matches_f32_grads():
    """Key-averaged SR weight gradients converge to the f32 ones; one
    draw sits within bf16 noise of them."""
    rng = np.random.default_rng(3)
    w = _t((rng.normal(size=(48, 24)) * 0.3).astype(np.float32))
    b = torch.zeros(24)
    x = _t((rng.normal(size=(256, 48)) * 0.5).astype(np.float32))
    g_out = _t(rng.normal(size=(256, 24)).astype(np.float32))
    g_ref = x.T @ g_out
    gen = torch.Generator().manual_seed(100)

    def sr_grad():
        wv = w.clone().requires_grad_(True)
        y = tnerf._dense({'w': wv, 'b': b}, x.to(BF16), BF16, True,
                         tnerf.sr_salt(gen))
        return torch.autograd.grad((y * g_out).sum(), wv)[0].double()

    mean = sum(sr_grad() for _ in range(64)) / 64
    scale = g_ref.abs().max().item()
    err_single = (sr_grad() - g_ref).abs().max().item() / scale
    err_mean = (mean - g_ref).abs().max().item() / scale
    assert err_mean < err_single
    assert err_mean < 2.5e-2, (err_mean, err_single)


# ------------------------------------------------------------ dense / MLP

@pytest.mark.parametrize('sr', [False, True])
def test_dense_mixed_matches_jax(sr):
    """_DenseMixed against JAX's _dense_mixed: forward, gw, gb, gx; the SR
    twin's forward is the same bits, and its gradients are unbiased
    draws around them (within one bf16 step of the largest)."""
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(40, 24)) * 0.3).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    x = rng.normal(size=(3, 50, 40)).astype(np.float32)
    g = rng.normal(size=(3, 50, 24)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)

    def jf(w_, b_, x_):
        return jnp.vdot(jnerf._dense_mixed(w_, b_, x_, jnp.bfloat16),
                        jnp.asarray(g))
    yj = jnerf._dense_mixed(jnp.asarray(w), jnp.asarray(b), xj,
                            jnp.bfloat16)
    gj = jax.grad(jf, (0, 1, 2))(jnp.asarray(w), jnp.asarray(b), xj)

    tw, tb = _t(w).requires_grad_(True), _t(b).requires_grad_(True)
    tx = _t(x).to(BF16).requires_grad_(True)
    key = tnerf.sr_salt(torch.Generator().manual_seed(0)) if sr else None
    y = tnerf._dense({'w': tw, 'b': tb}, tx, BF16, True, key)
    gt = torch.autograd.grad((y * _t(g)).sum(), (tw, tb, tx))
    assert y.dtype == torch.float32 and gt[2].dtype == BF16
    assert _relmax(_f32(y), _f32(yj)) < 1e-6
    tol = 2e-2 if sr else 5e-3
    for a, bj, name in zip(gt, gj, ('gw', 'gb', 'gx')):
        assert _relmax(_f32(a), _f32(bj)) < tol, name


def _mlp(width=64, depth=4):
    cfg = tnerf.NeRFConfig(depth=depth, width=width, input_ch=40,
                           input_ch_bones=24, input_ch_views=36, skips=(2,),
                           use_framecode=True, n_framecodes=4)
    jcfg = jnerf.NeRFConfig(**dataclasses.asdict(cfg))
    params = jnerf.init_nerf_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize('knob', ['default', 'fast_grads', 'alpha_f32'])
def test_apply_nerf_knob_matches_jax(knob):
    """apply_nerf at 64 x 4 with bf16 compute: the raw outputs and every
    leaf's and input's gradient against JAX's apply_nerf with the knob."""
    cfg, jcfg, params = _mlp()
    kw = dict(fast_grads=knob != 'default', alpha_f32=knob == 'alpha_f32')
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(6, 20, cfg.dnet_input)).astype(np.float32)
    views = rng.normal(size=(6, 20, cfg.input_ch_views)).astype(np.float32)
    fc = rng.normal(size=(6, 20, cfg.framecode_ch)).astype(np.float32)
    g = rng.normal(size=(6, 20, 4)).astype(np.float32)

    def jloss(p, x, v):
        raw = jnerf.apply_nerf(p, jcfg, x, v, jnp.asarray(fc), **kw)
        return jnp.vdot(raw, jnp.asarray(g)), raw
    (_, jraw), jgrads = jax.jit(jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts, jnp.bfloat16),
        jnp.asarray(views, jnp.bfloat16))

    tp = params_from_numpy(params, 'cpu')
    leaves, tdef = jax.tree.flatten(tp)
    for x in leaves:
        x.requires_grad_(True)
    tx = _t(pts).to(BF16).requires_grad_(True)
    tv = _t(views).to(BF16).requires_grad_(True)
    raw = tnerf.apply_nerf(tp, cfg, tx, tv, _t(fc), **kw)
    got = torch.autograd.grad((raw * _t(g)).sum(), leaves + [tx, tv],
                              allow_unused=True)
    assert _relmax(_f32(raw), _f32(jraw)) < 1e-6
    want = jax.tree.leaves(jgrads[0]) + list(jgrads[1:])
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.zeros_like(_f32(b)) if a is None else _f32(a)
        assert _relmax(a, _f32(b)) < 5e-3, (knob, i)


# ---------------------------------------------------------------- the PE

def _pe_inputs(view):
    """A reldist kp window (inputs are the distances) or a broadcast view
    window ((R, 1, 72) directions windowed by (R, S, 24) distances)."""
    rng = np.random.default_rng(11)
    R, S = 4, 6
    dists = rng.uniform(0.05, 0.6, size=(R, S, 24)).astype(np.float32)
    cut = rng.uniform(0.2, 0.4, size=(24,)).astype(np.float32)
    if view:
        cfg = dict(input_dims=72, num_freqs=4, cutoff=True,
                   cutoff_inputs=True, dist_inputs=True)
        x = rng.normal(size=(R, 1, 72)).astype(np.float32)
    else:
        cfg = dict(input_dims=24, num_freqs=5, cutoff=True,
                   cutoff_inputs=True)
        x = dists
    return cfg, x, dists, cut


def _embed_both(cfg_kw, x, dists, cut, tau=35.0, alpha=None, **knobs):
    """(port output, JAX output, port grads, JAX grads) of embed with the
    same knobs, for a random cotangent; grads w.r.t. x (and dists where
    they are a separate input)."""
    jcfg = jemb.EmbedConfig(**cfg_kw)
    tcfg = temb.EmbedConfig(**cfg_kw)
    jk = {k: jnp.bfloat16 for k, v in knobs.items() if v}
    tk = {k: BF16 for k, v in knobs.items() if v}
    sep = cfg_kw.get('dist_inputs', False)

    def jf(x_, d_):
        out, _ = jemb.embed(jcfg, x_, dists=d_, cutoff_dist=jnp.asarray(cut),
                            tau=tau, alpha=alpha, **jk)
        return out
    jout, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(dists))
    g = np.random.default_rng(2).normal(size=jout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(g, jout.dtype))

    tx = _t(x).requires_grad_(True)
    td = _t(dists).requires_grad_(True) if sep else tx
    tout, _ = temb.embed(tcfg, tx, dists=td, cutoff_dist=_t(cut), tau=tau,
                         alpha=alpha, **tk)
    wrt = [tx, td] if sep else [tx]
    tg = torch.autograd.grad(tout, wrt, _t(g).to(tout.dtype),
                             allow_unused=True)
    if not sep:    # JAX's dists are the same inputs: sum both cotangents
        jg = (jg[0] + jg[1],)
    return tout, jout, tg, jg


@pytest.mark.parametrize('view', [False, True], ids=['kp', 'view'])
@pytest.mark.parametrize('knob', ['out_dtype', 'hifi_dtype', 'remat_dtype'])
def test_embed_knob_matches_jax(knob, view):
    cfg_kw, x, dists, cut = _pe_inputs(view)
    tout, jout, tg, jg = _embed_both(cfg_kw, x, dists, cut, **{knob: True})
    assert tout.dtype == BF16 and tout.shape == jout.shape
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=1e-2, rtol=0)
    tol = {'out_dtype': 2e-2, 'hifi_dtype': 5e-3, 'remat_dtype': 1e-5}[knob]
    for a, b in zip(tg, jg):
        assert _relmax(_f32(a), _f32(b)) < tol, (knob, view)


CAT_MODES = [dict(), dict(cutoff_inputs=False)]


@pytest.mark.parametrize('mode', CAT_MODES, ids=['cutoff_inputs', 'after'])
@pytest.mark.parametrize('view', [False, True], ids=['kp', 'view'])
@pytest.mark.parametrize('knob', ['hifi_dtype', 'remat_dtype'])
def test_hifi_remat_forward_bit_equal_default(knob, view, mode):
    cfg_kw, x, dists, cut = _pe_inputs(view)
    cfg = temb.EmbedConfig(**{**cfg_kw, **mode})
    kw = dict(dists=_t(dists), cutoff_dist=_t(cut), tau=35.0)
    base, wb = temb.embed(cfg, _t(x), **kw)
    got, wg = temb.embed(cfg, _t(x), **kw, **{knob: BF16})
    assert got.dtype == BF16
    assert torch.equal(got, base.to(BF16)) and torch.equal(wg, wb)


@pytest.mark.parametrize('view', [False, True], ids=['kp', 'view'])
def test_remat_grads_match_default(view):
    """remat's rematerialized f32 backward against autograd through the
    default chain and the cast: every input's gradient within 1e-5."""
    cfg_kw, x, dists, cut = _pe_inputs(view)
    cfg = temb.EmbedConfig(**cfg_kw)
    g = _t(np.random.default_rng(4).normal(
        size=(4, 6, cfg.out_dim)).astype(np.float32)).to(BF16)

    def grads(**knob):
        tx = _t(x).requires_grad_(True)
        td = _t(dists).requires_grad_(True)
        c = _t(cut).requires_grad_(True)
        out, _ = temb.embed(cfg, tx, dists=td if view else tx,
                            cutoff_dist=c, tau=35.0, **knob)
        return torch.autograd.grad(out.to(BF16), [tx, td, c] if view
                                   else [tx, c], g)
    for a, b in zip(grads(remat_dtype=BF16), grads()):
        assert _relmax(a.numpy(), b.numpy()) < 1e-5


# ---------------------------------------------------------- the whole step

STEP_CASES = {
    'fast_grads_culled': dict(fast_grads=True, cull_ratio=0.25,
                              N_samples=16),
    'fast_mlp_alpha_f32_hifi': dict(fast_mlp=True, alpha_f32=True,
                                    hifi_pe=True),
    'remat_pe': dict(remat_pe=True),
    'sr_grads': dict(sr_grads=True),
    # the schedule at step 0: alpha = init_freq = 1.5, band 1 half open
    'freq_schedule': dict(freq_schedule=True, init_freq=1.5),
    # the (R, S, J, 3) path; axisang reads axis-angle bones
    'relpos_axisang_rayangle': dict(kp_dist_type='relpos',
                                    bone_type='axisang',
                                    view_type='rayangle', opt_rot6d=False),
}


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_train_step_knob_matches_jax(case):
    """One make_train_step step (64 x 4, bf16, pose refinement, 16 rays,
    8 + 4 samples, test mode) on the plain branch against
    make_train_step(raw=True) with the same knobs, the frequency
    schedule's alpha from each trainer's derive_schedules, and a non-flat
    encoder configuration. sr_grads draws its
    keys from each package's own generator, so its gradients are two
    unbiased draws: held to the same bounds, which bf16 noise fits."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(rng, **{
        **dict(netwidth=64, netwidth_fine=64, compute_dtype='bfloat16',
               opt_pose=True, opt_rot6d=True, opt_pose_step=1,
               N_samples=8), **STEP_CASES[case]})
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = (
            params[net]['alpha_linear']['b'] + 2.0)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    _check_step(args, cfg.test_mode(), params, pose, batch)


def _check_step(args, jcfg, params, pose, batch, loss_rtol=1e-4):
    jpc = jpose.PoseOptConfig(use_rot6d=args.opt_rot6d)
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
    jstep = j_make_train_step(args, jcfg, jpc, jnp.asarray(pose['rest_pose']),
                              opt, popt, raw=True, tau_fixed=35.0)
    jnew, jout = jax.jit(jstep)(jstate, batch, jax.random.PRNGKey(0))

    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]}
    ).test_mode()
    assert not tcfg.use_fused
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    topt = tst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                   args.lrate_decay_rate, args.decay_unit)
    tpopt = tst.make_pose_optimizer(args.opt_pose_lrate,
                                    args.opt_pose_lrate_decay,
                                    args.opt_pose_decay_rate,
                                    args.opt_pose_decay_unit)
    step = make_train_step(args, tcfg,
                           tpose.PoseOptConfig(use_rot6d=args.opt_rot6d),
                           _t(pose['rest_pose']), topt, tpopt,
                           tau_fixed=35.0)
    tb = {k: _t(v) for k, v in batch.items()}
    for k in ('cam_idxs', 'pose_idx', 'kp_idxs'):
        tb[k] = tb[k].long()
    new, out = step(state, tb, torch.Generator().manual_seed(0))
    for k, v in jout['losses'].items():
        a, b = float(v), float(out['losses'][k])
        assert abs(a - b) <= loss_rtol * max(abs(a), 1e-6), (k, a, b)
    mu, jmu = new.opt_state.mu.numpy(), np.asarray(jnew.opt_state[0].mu)
    assert np.abs(jmu).max() > 0 and _relmax(mu, jmu) < 2e-2
    pmu = new.pose_opt_state.mu.numpy()
    jpmu = np.asarray(jnew.pose_opt_state[0].mu)
    assert np.abs(jpmu).max() > 0 and _relmax(pmu, jpmu) < 2e-2
    assert _relmax(tst.flatten_tree(new.params).numpy(),
                   ravel_pytree(jnew.params)[0]) < 1e-3
    return new, out
