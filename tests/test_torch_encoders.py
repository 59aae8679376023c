"""The port's encoder kinds, embedder window modes, frequency schedule and
the ray / cylinder / merge leftovers against anerf_tpu, on the CPU.

Inputs come from numpy's default_rng and go through both packages.
Tolerances, each with what was observed:
  * fp32 geometry (transforms, encoders, angles, rays, cylinders): 1e-5
    absolute and relative (both sides fp32, other summation orders;
    observed <= 9.6e-7 absolute); calculate_angle's gradient 1e-4.
  * the PE and encode_inputs in f32: values 1e-4 absolute (f32 sin of
    arguments up to ~50 rad, tests/test_torch_ops.py; observed <= 2.4e-7);
    gradients 1e-4 relative to each one's largest value (observed
    <= 1.6e-7).
  * render_rays of a non-flat config in bf16, from JAX's params carried
    over by convert.params_from_numpy: 5e-3 absolute / relative
    (tests/test_torch_render.py's bound; observed 1.2e-4).
  * the schedule window 1e-6 absolute (observed 0); merge_sorted,
    stable_ranks, kp_to_valid_rays_np: exact (gathers and integer
    boxes); get_rays and pack_rays 1e-6 (observed 0).
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from anerf_tpu.ops import cylinder as jcyl
from anerf_tpu.ops import embedder as jemb
from anerf_tpu.ops import encoding as jenc
from anerf_tpu.ops import rays as jrays
from anerf_tpu.ops import sampling as jsamp
from anerf_tpu.render.raycaster import encode_inputs as j_encode_inputs
from anerf_tpu.render.raycaster import render_rays as j_render_rays

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.ops import cylinder as tcyl
from anerf_torch.ops import embedder as temb
from anerf_torch.ops import encoding as tenc
from anerf_torch.ops import rays as trays
from anerf_torch.ops import sampling as tsamp
from anerf_torch.render.factory import build_render_config
from anerf_torch.render.raycaster import encode_inputs, render_rays
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny, synthetic_batch

GEOM = dict(atol=1e-5, rtol=1e-5)
PE = dict(atol=1e-4, rtol=0)
R, S, J = 3, 5, 24


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _skts(rng, R_=R):
    rot = Rotation.from_rotvec(rng.normal(size=(R_ * J, 3))).as_matrix()
    m = np.tile(np.eye(4), (R_ * J, 1, 1))
    m[:, :3, :3] = rot
    m[:, :3, 3] = rng.normal(size=(R_ * J, 3)) * 0.5
    return m.reshape(R_, J, 4, 4).astype(np.float32)


@pytest.fixture(scope='module')
def geo():
    rng = np.random.default_rng(0)
    return {'pts': rng.normal(size=(R, S, 3)).astype(np.float32),
            'rays_d': rng.normal(size=(R, 1, 3)).astype(np.float32),
            'kps': rng.normal(size=(R, J, 3)).astype(np.float32) * 0.5,
            'bones': rng.normal(size=(R, J, 3)).astype(np.float32),
            'skts': _skts(rng)}


# ------------------------------------------------------------ geometry

def test_transform_batch_pts_and_rays_match_jax(geo):
    got = tenc.transform_batch_pts(_t(geo['pts']), _t(geo['skts']))
    want = jenc.transform_batch_pts(jnp.asarray(geo['pts']),
                                    jnp.asarray(geo['skts']))
    assert got.shape == (R, S, J, 3)
    np.testing.assert_allclose(_n(got), want, **GEOM)
    got = tenc.transform_batch_rays(_t(geo['rays_d']), _t(geo['skts']))
    want = jenc.transform_batch_rays(jnp.asarray(geo['rays_d']),
                                     jnp.asarray(geo['skts']))
    assert got.shape == (R, 1, J, 3)
    np.testing.assert_allclose(_n(got), want, **GEOM)


def test_calculate_angle_matches_jax_and_is_finite_at_a_joint(geo):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(R, S, J, 3)).astype(np.float32)
    b = rng.normal(size=(R, 1, J, 3)).astype(np.float32)
    b[0, 0, :2] = a[0, 0, :2] * 3.0          # parallel: the clamp binds
    ta = _t(a).requires_grad_(True)
    got = tenc.calculate_angle(ta, _t(b))
    want = jenc.calculate_angle(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_n(got), want, **GEOM)
    g = torch.autograd.grad(got.sum(), ta)[0]
    jg = jax.grad(lambda x: jenc.calculate_angle(x, jnp.asarray(b)).sum())(
        jnp.asarray(a))
    np.testing.assert_allclose(_n(g), jg, atol=1e-4, rtol=1e-4)
    # a sample exactly on a joint: zero local vector, finite gradient
    a[1, 2, 5] = 0.0
    ta = _t(a).requires_grad_(True)
    out = tenc.calculate_angle(ta, _t(b))
    g = torch.autograd.grad(out.sum(), ta)[0]
    assert torch.isfinite(out).all() and torch.isfinite(g).all()
    assert out[1, 2, 5].item() == pytest.approx(0.0, abs=1e-6)


# ------------------------------------------------------------- encoders

@pytest.mark.parametrize('local', [True, False], ids=['pts_t', 'world'])
@pytest.mark.parametrize('kind', ['reldist', 'relpos', 'cat', 'querypts'])
def test_kp_encoder_matches_jax(geo, kind, local):
    tspec, tdims, tcut = tenc.make_kp_encoder(kind)
    jspec, jdims, jcut = jenc.make_kp_encoder(kind)
    assert (tspec.name, tspec.dims, tdims, tcut) == (jspec.name, jspec.dims,
                                                     jdims, jcut)
    pts_t = (jenc.transform_batch_pts(jnp.asarray(geo['pts']),
                                      jnp.asarray(geo['skts']))
             if local else None)
    want = jspec(jnp.asarray(geo['pts']), pts_t, jnp.asarray(geo['kps']))
    got = tspec(_t(geo['pts']), None if pts_t is None else _t(pts_t),
                _t(geo['kps']))
    assert got.shape == (R, S, tdims)
    np.testing.assert_allclose(_n(got), want, **GEOM)


@pytest.mark.parametrize('kind', ['reldir', 'axisang', 'Nope'])
def test_bone_encoder_matches_jax(geo, kind):
    tspec, tdims = tenc.make_bone_encoder(kind)
    jspec, jdims = jenc.make_bone_encoder(kind)
    assert (tspec.name, tdims) == (jspec.name, jdims)
    pts_t = jenc.transform_batch_pts(jnp.asarray(geo['pts']),
                                     jnp.asarray(geo['skts']))
    want = jspec(pts_t, bones=jnp.asarray(geo['bones']),
                 refs=jnp.asarray(geo['pts']))
    got = tspec(_t(pts_t), bones=_t(geo['bones']), refs=_t(geo['pts']))
    if kind == 'Nope':
        assert got is None and want is None
        return
    assert got.shape == (R, S, tdims)
    np.testing.assert_allclose(_n(got), want, **GEOM)


@pytest.mark.parametrize('kind', ['relray', 'rayangle', 'world'])
def test_view_encoder_matches_jax(geo, kind):
    """Each view encoder on the rays its JAX spec reads: per-joint rays,
    or for 'world' the world-frame direction (R, 1, 3) that the port's
    encode_inputs hands it."""
    tspec, tdims = tenc.make_view_encoder(kind)
    jspec, jdims = jenc.make_view_encoder(kind)
    assert (tspec.name, tdims) == (jspec.name, jdims)
    skts, rays_d = jnp.asarray(geo['skts']), jnp.asarray(geo['rays_d'])
    pts_t = jenc.transform_batch_pts(jnp.asarray(geo['pts']), skts)
    rays_t = rays_d if kind == 'world' \
        else jenc.transform_batch_rays(rays_d, skts)
    refs = None if kind == 'relray' else geo['pts']
    want = jspec(rays_t, pts_t=pts_t,
                 refs=None if refs is None else jnp.asarray(refs))
    got = tspec(_t(rays_t), pts_t=_t(pts_t),
                refs=None if refs is None else _t(refs))
    assert got.shape[-1] == tdims
    np.testing.assert_allclose(_n(got), want, **GEOM)


# -------------------------------------------------------- embedder modes

WINDOW_MODES = {
    'cut_to_cutoff': dict(cut_to_cutoff=True),
    'shift_inputs': dict(shift_inputs=True),
    'cut_and_shift': dict(cut_to_cutoff=True, shift_inputs=True),
    'normalize': dict(normalize=True),
    'after_window': dict(cutoff_inputs=False),
    'no_include': dict(include_input=False),
    'freq_schedule': dict(freq_schedule=True),
    'freq_schedule_normalize': dict(freq_schedule=True, normalize=True,
                                    cutoff_inputs=False),
}


@pytest.mark.parametrize('mode', list(WINDOW_MODES))
def test_embed_window_mode_matches_jax(mode):
    """A reldist kp window (the inputs are the distances) in each mode:
    values and the input gradient for a random cotangent. alpha 2.3
    opens bands 0-2 and 30 % of band 3; with normalize, 4.6 (bands 0-3
    and 60 % of band 4), since a closed band's zero 3-vectors give JAX a
    NaN gradient (see test_normalize_grad_finite_on_a_closed_band)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0.05, 0.6, size=(4, 6, 24)).astype(np.float32)
    cut = rng.uniform(0.2, 0.4, size=(24,)).astype(np.float32)
    kw = {**dict(input_dims=24, num_freqs=5, cutoff=True,
                 cutoff_inputs=True), **WINDOW_MODES[mode]}
    jcfg, tcfg = jemb.EmbedConfig(**kw), temb.EmbedConfig(**kw)
    alpha = 4.6 if 'normalize' in mode else 2.3

    def jf(x_):
        return jemb.embed(jcfg, x_, dists=x_, cutoff_dist=jnp.asarray(cut),
                          tau=35.0, alpha=jnp.float32(alpha))[0]
    want, vjp = jax.vjp(jf, jnp.asarray(x))
    g = rng.normal(size=want.shape).astype(np.float32)
    tx = _t(x).requires_grad_(True)
    got, w = temb.embed(tcfg, tx, dists=tx, cutoff_dist=_t(cut), tau=35.0,
                        alpha=alpha)
    assert got.shape == want.shape == (4, 6, tcfg.out_dim)
    np.testing.assert_allclose(_n(got), want, **PE)
    tg = torch.autograd.grad(got, tx, _t(g))[0]
    assert _relmax(_n(tg), vjp(jnp.asarray(g))[0]) < 1e-4


def test_normalize_grad_finite_on_a_closed_band():
    """normalize where the schedule closes bands 3-4: their 3-vectors are
    exactly zero, and the port's gradient there is 0 (vector_norm's at
    0). JAX's is NaN (0 * inf in the derivative of sqrt at 0), which a
    pose-refining step would carry into the poses."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0.05, 0.6, size=(4, 6, 24)).astype(np.float32)
    cfg = temb.EmbedConfig(input_dims=24, num_freqs=5, cutoff=True,
                           cutoff_inputs=False, normalize=True,
                           freq_schedule=True)
    tx = _t(x).requires_grad_(True)
    out, _ = temb.embed(cfg, tx, dists=tx, cutoff_dist=_t(np.full(24, 0.3,
                                                                  np.float32)),
                        tau=35.0, alpha=2.3)
    closed = out.reshape(4, 6, -1, 24)[:, :, 1 + 2 * 3:]
    assert torch.equal(closed, torch.zeros_like(closed))
    g = torch.autograd.grad(out, tx, torch.ones_like(out))[0]
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize('alpha', [None, -0.5, 0.0, 1.7, 4.0, 9.0])
def test_schedule_w_matches_jax(alpha):
    cfg_kw = dict(input_dims=24, num_freqs=5, cutoff=True,
                  freq_schedule=True)
    want = jemb._schedule_w(jemb.EmbedConfig(**cfg_kw),
                            None if alpha is None else jnp.float32(alpha))
    got = temb._schedule_w(temb.EmbedConfig(**cfg_kw), alpha)
    if got is None:                  # JAX multiplies by ones
        np.testing.assert_array_equal(want, np.ones((1, 1), np.float32))
        return
    assert got.shape == (10, 1)
    np.testing.assert_allclose(_n(got), want, atol=1e-6, rtol=0)


def test_freq_schedule_alpha_matches_jax():
    """alpha_schedule's value at a few steps (the host arithmetic)."""
    cfg_kw = dict(input_dims=24, num_freqs=7, cutoff=True,
                  freq_schedule=True, init_alpha=0.5)
    for step in (0, 1234, 5000, 99999):
        want = jemb.alpha_schedule(jemb.EmbedConfig(**cfg_kw),
                                   jnp.int32(step), 5, 6.0)
        got = temb.alpha_schedule(temb.EmbedConfig(**cfg_kw), step, 5, 6.0)
        assert got == pytest.approx(float(want), rel=1e-6)


# ------------------------------------------------- encode_inputs, the path

ENCODER_CFGS = {
    'relpos_axisang_rayangle': dict(kp_dist_type='relpos',
                                    bone_type='axisang',
                                    view_type='rayangle', cutoff_bones=True,
                                    multires_bones=2),
    'reldist_axisang_rayangle_sched': dict(
        bone_type='axisang', view_type='rayangle', freq_schedule=True,
        cut_to_dist=True, cutoff_shift=True, normalize_cutoff=True),
    'cat_reldir_relray': dict(kp_dist_type='cat', use_cutoff=False),
    'querypts_nope_relray': dict(kp_dist_type='querypts', bone_type='Nope',
                                 cutoff_viewdir=False),
}


def _cfgs(name):
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(rng, **ENCODER_CFGS[name])
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    return rng, args, cfg, tcfg, params, pose


@pytest.mark.parametrize('name', list(ENCODER_CFGS))
def test_encode_inputs_matches_jax(name):
    """encode_inputs in f32 on the (R, S, J, 3) path: the v / r / d
    encodings and the gradient w.r.t. skts of a random projection."""
    rng, args, cfg, tcfg, params, pose = _cfgs(name)
    assert tcfg.nerf == dataclasses.replace(
        tcfg.nerf, **dataclasses.asdict(cfg.nerf))
    batch = synthetic_batch(rng, pose, n_rays=8, n_images=4)
    pr = lambda k: np.asarray(batch[k][batch['pose_idx']])
    rays = np.asarray(batch['rays'])
    pts = (rays[:, None, :3] + rays[:, None, 3:6]
           * np.linspace(2.6, 3.4, 6, dtype=np.float32)[None, :, None])
    # bands 0-1 open, band 2 half (a closed band: see
    # test_normalize_grad_finite_on_a_closed_band)
    alpha = 2.5 if cfg.embed_kp.freq_schedule else None
    cut = np.asarray(params['cutoff_dist'])

    kp, bones = pr('kp3d'), pr('bones')

    def jf(skts):
        enc = j_encode_inputs(cfg, jnp.asarray(pts), jnp.asarray(
            rays[:, None, 3:6]), jnp.asarray(kp), skts, jnp.asarray(bones),
            jnp.asarray(cut), jnp.float32(30.0),
            None if alpha is None else jnp.float32(alpha))
        return {k: v for k, v in enc.items() if v is not None}
    want, vjp = jax.vjp(jax.jit(jf), jnp.asarray(pr('skts')))
    cots = {k: np.random.default_rng(3).normal(size=v.shape).astype(
        np.float32) for k, v in want.items()}

    tsk = _t(pr('skts')).requires_grad_(True)
    got = encode_inputs(tcfg, _t(pts), _t(rays[:, None, 3:6]),
                        _t(pr('kp3d')), tsk, _t(pr('bones')), _t(cut), 30.0,
                        alpha)
    assert {k for k, v in got.items() if v is not None} == set(want)
    for k in want:
        np.testing.assert_allclose(_n(got[k]), want[k], err_msg=k, **PE)
    # encodings that do not read skts (world points, bones, world rays)
    # get a zero cotangent from JAX too
    proj = sum((got[k] * _t(cots[k])).sum() for k in want
               if got[k].requires_grad)
    tg = _n(torch.autograd.grad(proj, tsk)[0])
    jg = np.asarray(vjp({k: jnp.asarray(v) for k, v in cots.items()})[0])
    # with normalize, a window closed to exactly 0 gives JAX NaN
    # gradients (test_normalize_grad_finite_on_a_closed_band): compare
    # where JAX's are finite; the port's are finite everywhere
    ok = np.isfinite(jg)
    assert np.isfinite(tg).all() and ok.any()
    assert ok.all() or cfg.embed_kp.normalize
    assert _relmax(tg[ok], jg[ok]) < 1e-4


@pytest.mark.parametrize('name', ['relpos_axisang_rayangle',
                                  'cat_reldir_relray'])
def test_render_rays_non_flat_matches_jax(name):
    """render_rays in test mode, 64 wide in bf16, from JAX's params carried
    over one to one by params_from_numpy (the widths relpos / cat give
    dnet_input, rayangle the views)."""
    rng = np.random.default_rng(0)
    over = dict(ENCODER_CFGS[name], netwidth=64, netwidth_fine=64,
                compute_dtype='bfloat16')
    args, cfg, params, pose = build_tiny(rng, **over)
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = (
            params[net]['alpha_linear']['b'] + 2.0)
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    assert (tparams['coarse']['pts_linears'][0]['w'].shape[0]
            == tcfg.nerf.dnet_input == cfg.nerf.dnet_input)
    batch = synthetic_batch(rng, pose, n_rays=8, n_images=4)
    pr = lambda k: batch[k][batch['pose_idx']]
    want = jax.jit(lambda p, b: j_render_rays(
        p, cfg.test_mode(), b['rays'], b['kp3d'][b['pose_idx']],
        b['skts'][b['pose_idx']], b['bones'][b['pose_idx']],
        b['cyls'][b['pose_idx']], cam_idxs=b['cam_idxs'],
        tau=jnp.float32(35.0)))(params, batch)
    got = render_rays(tparams, tcfg.test_mode(), _t(batch['rays']),
                      _t(pr('kp3d')), _t(pr('skts')), _t(pr('bones')),
                      _t(pr('cyls')), cam_idxs=_t(batch['cam_idxs']).long(),
                      tau=35.0)
    assert float(np.abs(np.asarray(want['acc_map'])).max()) > 1e-2
    for k in want:
        np.testing.assert_allclose(_n(got[k]), want[k], atol=5e-3,
                                   rtol=5e-3, err_msg=k)


def test_world_view_runs_where_jax_fails():
    """'world' on the port reads the world-frame ray direction (its
    declared width 3, 3 * (1 + 2 * multires_views) view inputs) and
    renders finite values with gradients; the JAX package feeds it the
    per-joint rays and fails in the first view layer."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(rng, view_type='world',
                                         cutoff_viewdir=False)
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    assert tcfg.nerf.input_ch_views == 3 * (1 + 2 * args.multires_views)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    batch = synthetic_batch(rng, pose, n_rays=8, n_images=4)
    pr = lambda k: _t(batch[k][batch['pose_idx']])
    with pytest.raises(TypeError):
        j_render_rays(params, cfg.test_mode(), batch['rays'],
                      batch['kp3d'][batch['pose_idx']],
                      batch['skts'][batch['pose_idx']],
                      batch['bones'][batch['pose_idx']],
                      batch['cyls'][batch['pose_idx']],
                      cam_idxs=batch['cam_idxs'], tau=jnp.float32(35.0))
    w0 = tparams['coarse']['views_linears'][0]['w'].requires_grad_(True)
    out = render_rays(tparams, tcfg.test_mode(), _t(batch['rays']),
                      pr('kp3d'), pr('skts'), pr('bones'), pr('cyls'),
                      cam_idxs=_t(batch['cam_idxs']).long(), tau=35.0)
    g = torch.autograd.grad(out['rgb0'].sum(), w0)[0]
    assert all(torch.isfinite(v).all() for v in out.values())
    assert out['acc0'].max() > 0 and torch.isfinite(g).all()
    assert g.abs().max() > 0


# ------------------------------------------------- rays, cylinder, merge

def test_get_rays_and_pack_rays_match_jax():
    rng = np.random.default_rng(4)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    c2w[:3, 3] = rng.normal(size=3)
    for center in (None, (5.0, 3.5)):
        want = jrays.get_rays(6, 8, (9.0, 7.0), jnp.asarray(c2w), center)
        got = trays.get_rays(6, 8, (9.0, 7.0), _t(c2w), center)
        for a, b in zip(got, want):
            assert a.shape == (6, 8, 3)
            np.testing.assert_allclose(_n(a), b, atol=1e-6, rtol=1e-6)
    o = want[0].reshape(-1, 3)
    d = want[1].reshape(-1, 3)
    near = rng.uniform(0.1, 0.5, size=48).astype(np.float32)
    for nf, vd in (((0.35, 2.75), True), ((near, near + 2.0), False)):
        want_p = jrays.pack_rays(o, d, *[jnp.asarray(v) if np.ndim(v) else v
                                         for v in nf], use_viewdirs=vd)
        got_p = trays.pack_rays(_t(o), _t(d), *nf, use_viewdirs=vd)
        assert got_p.shape == want_p.shape == (48, 11 if vd else 8)
        np.testing.assert_allclose(_n(got_p), want_p, atol=1e-6, rtol=1e-6)


def test_kp_to_valid_rays_np_matches_jax():
    rng = np.random.default_rng(5)
    kps = (rng.normal(size=(3, 24, 3)) * 0.3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0 + np.arange(3)
    for kw in (dict(kps=kps), dict(cylinder_params=jcyl.get_kp_bounding_cylinder(
            kps, ext_scale=0.001, head='-y'))):
        want = jrays.kp_to_valid_rays_np(poses, 40, 32, 30.0, **kw)
        got = trays.kp_to_valid_rays_np(poses, 40, 32, 30.0, **kw)
        np.testing.assert_array_equal(got[2], want[2])
        for (go, gd), (wo, wd), gi, wi, gb, wb in zip(
                got[0], want[0], got[1], want[1], got[3], want[3]):
            assert gi.size > 0
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(go, wo)
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))


def test_near_far_in_cylinder_np_matches_jax():
    rng = np.random.default_rng(6)
    o = rng.normal(size=(64, 3)).astype(np.float32) * 0.2 + [0, 0, 3]
    d = rng.normal(size=(64, 3)).astype(np.float32) * 0.2 + [0, 0, -1]
    cyl = np.array([0.05, -0.02, 2.0, 1.0, -1.0], np.float32)
    got = tcyl.get_near_far_in_cylinder_np(o, d, cyl)
    want = jcyl.get_near_far_in_cylinder_np(o, d, cyl)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GEOM)
        assert np.isfinite(a).all()


def test_merge_sorted_matches_jax():
    """Stable ranks (ties among coarse and fine z) and the merge of a
    (R, S, 4) / (R, I, 4) pair; the gradient goes back to both."""
    rng = np.random.default_rng(7)
    z = np.sort(rng.uniform(1, 3, size=(6, 10)), -1).astype(np.float32)
    zi = np.sort(rng.uniform(1, 3, size=(6, 5)), -1).astype(np.float32)
    zi[:, 0] = z[:, 3]                                     # tied z
    ranks_j = jsamp.stable_ranks(jnp.asarray(np.concatenate([z, zi], -1)))
    ranks_t = tsamp.stable_ranks(_t(np.concatenate([z, zi], -1)))
    np.testing.assert_array_equal(_n(ranks_t), ranks_j)
    a = rng.normal(size=(6, 10, 4)).astype(np.float32)
    b = rng.normal(size=(6, 5, 4)).astype(np.float32)
    want = jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b), ranks_j)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    got = tsamp.merge_sorted(ta, tb, ranks_t)
    np.testing.assert_array_equal(_n(got), want)
    g = rng.normal(size=want.shape).astype(np.float32)
    ga, gb = torch.autograd.grad(got, (ta, tb), _t(g))
    ja, jb = jax.vjp(lambda x, y: jsamp.merge_sorted(x, y, ranks_j),
                     jnp.asarray(a), jnp.asarray(b))[1](jnp.asarray(g))
    np.testing.assert_array_equal(_n(ga), ja)
    np.testing.assert_array_equal(_n(gb), jb)
