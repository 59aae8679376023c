"""anerf_torch ops against their anerf_tpu counterparts, on the CPU.

Inputs come from numpy's default_rng and go through both packages.
Tolerances: fp32 geometry at 1e-5 (both sides compute in fp32, in other
summation orders); the positional encoding at 1e-4 abs, because f32 sin
of arguments up to ~200 rad (2^6 * v) is accurate to ~1e-5 and the two
libraries round the argument reduction differently.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anerf_tpu.ops import compositing as jcomp
from anerf_tpu.ops import cylinder as jcyl
from anerf_tpu.ops import embedder as jemb
from anerf_tpu.ops import encoding as jenc
from anerf_tpu.ops import fk as jfk
from anerf_tpu.ops import rotations as jrot
from anerf_tpu.ops import sampling as jsamp
from anerf_tpu.skeleton import smpl_rest_pose

from anerf_torch.ops import compositing as tcomp
from anerf_torch.ops import cylinder as tcyl
from anerf_torch.ops import embedder as temb
from anerf_torch.ops import encoding as tenc
from anerf_torch.ops import fk as tfk
from anerf_torch.ops import rotations as trot
from anerf_torch.ops import sampling as tsamp

GEOM = dict(atol=1e-5, rtol=1e-5)
PE = dict(atol=1e-4, rtol=0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _axisang(rng, n):
    a = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    a[:4] *= 1e-6                     # the small-angle Taylor branch
    return a


@pytest.mark.parametrize('dim', [3, 6])
def test_bones_to_rot(rng, dim):
    x = (_axisang(rng, 64) if dim == 3
         else rng.normal(size=(64, 6)).astype(np.float32))
    want = jrot.bones_to_rot(jnp.asarray(x))
    np.testing.assert_allclose(_n(trot.bones_to_rot(_t(x))), want, **GEOM)


def test_axisang_and_rot6d_to_rot(rng):
    a = _axisang(rng, 32)
    np.testing.assert_allclose(_n(trot.axisang_to_rot(_t(a))),
                               jrot.axisang_to_rot(jnp.asarray(a)), **GEOM)
    x6 = rng.normal(size=(32, 6)).astype(np.float32)
    np.testing.assert_allclose(_n(trot.rot6d_to_rot(_t(x6))),
                               jrot.rot6d_to_rot(jnp.asarray(x6)), **GEOM)


@pytest.mark.parametrize('dim', [3, 6])
def test_fk_matches_jax(rng, dim):
    N = 4
    bones = (rng.normal(size=(N, 24, dim)) * 0.5).astype(np.float32)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    pelvis = (rng.normal(size=(N, 3)) * 0.2).astype(np.float32)
    want = jfk.fk(jnp.asarray(bones), jnp.asarray(rest), jnp.asarray(pelvis))
    got = tfk.fk(_t(bones), _t(rest), _t(pelvis))
    for g, w, name in zip(got, want, ('kp3d', 'skts', 'l2ws', 'rots')):
        np.testing.assert_allclose(_n(g), w, err_msg=name, **GEOM)
    np.testing.assert_allclose(_n(tfk.rigid_inverse(got[1])), want[2],
                               **GEOM)


def test_get_smpl_l2ws_np_matches_jax(rng):
    pose = (rng.normal(size=(24, 3)) * 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        tfk.get_smpl_l2ws_np(pose, scale=0.3),
        jfk.get_smpl_l2ws_np(pose, scale=0.3))


def _skeleton(rng, n=3):
    bones = (rng.normal(size=(n, 24, 3)) * 0.2).astype(np.float32)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    pelvis = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    kp, skts, _, _ = jfk.fk(jnp.asarray(bones), jnp.asarray(rest),
                            jnp.asarray(pelvis))
    return np.asarray(kp), np.asarray(skts)


@pytest.mark.parametrize('head', ['-y', 'y'])
def test_bounding_cylinder_and_box(rng, head):
    kp, _ = _skeleton(rng)
    kw = dict(ext_scale=0.001, extend_mm=250, top_expand_ratio=1.6,
              bot_expand_ratio=1.1, head=head)
    cyl = tcyl.get_kp_bounding_cylinder(kp, **kw)
    np.testing.assert_array_equal(cyl, jcyl.get_kp_bounding_cylinder(kp,
                                                                     **kw))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = kp[0, 0] + [0.0, 0.0, 2.5]
    from anerf_tpu.ops.rays import nerf_c2w_to_extrinsic as j_ext
    from anerf_torch.ops.rays import nerf_c2w_to_extrinsic as t_ext
    np.testing.assert_array_equal(t_ext(c2w), j_ext(c2w))
    for got, want in zip(
            tcyl.cylinder_to_box_2d(cyl[0], [64, 64, 60.0], t_ext(c2w)),
            jcyl.cylinder_to_box_2d(cyl[0], [64, 64, 60.0], j_ext(c2w))):
        np.testing.assert_array_equal(got, want)


def test_near_far_in_cylinder(rng):
    R = 64
    kp, _ = _skeleton(rng, 1)
    cyl = jcyl.get_kp_bounding_cylinder(kp, ext_scale=0.001, head='-y')
    cyls = np.repeat(cyl, R, 0)
    o = np.broadcast_to(kp[0, 0] + [0.0, 0.2, 2.5], (R, 3)).astype(
        np.float32)
    # most rays aim at the body; the last quarter misses the cylinder and
    # takes the mean of the hits (the branch-free backfill)
    tgt = kp[0, 0] + rng.normal(size=(R, 3)) * 0.3
    tgt[3 * R // 4:, 0] += 5.0
    d = (tgt - o).astype(np.float32)
    near = np.full((R, 1), 0.0, np.float32)
    far = np.full((R, 1), 1.0, np.float32)
    want = jcyl.get_near_far_in_cylinder(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(cyls), near=near,
                                         far=far)
    got = tcyl.get_near_far_in_cylinder(_t(o), _t(d), _t(cyls), near=_t(near),
                                        far=_t(far))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), w, **GEOM)


def test_flat_transform_helpers(rng):
    _, skts = _skeleton(rng, 1)
    R, S = 8, 5
    skts = np.repeat(skts, R, 0)
    pts = rng.normal(size=(R, S, 3)).astype(np.float32)
    want = jenc.transform_batch_pts_flat(jnp.asarray(pts), jnp.asarray(skts))
    got = tenc.transform_batch_pts_flat(_t(pts), _t(skts))
    np.testing.assert_allclose(_n(got), want, **GEOM)
    np.testing.assert_allclose(_n(tenc._group3_sumsq(got, 24)),
                               jenc._group3_sumsq(want, 24), **GEOM)
    v = rng.uniform(size=(R, S, 24)).astype(np.float32)
    np.testing.assert_array_equal(_n(tenc._expand3(_t(v), 24)),
                                  jenc._expand3(jnp.asarray(v), 24))


@pytest.mark.parametrize('tau', [2000.0, 35.0])
def test_embed_cutoff_modes(rng, tau):
    R, S = 6, 5
    cut = np.full((24,), 0.5, np.float32)
    # kp: the inputs are the per-joint distances themselves
    kp_cfg, _ = jemb.make_embedder(7, 24, 0, {
        'cutoff': True, 'cutoff_inputs': True, 'cutoff_dim': 24,
        'dist_inputs': False})
    v = rng.uniform(0.0, 3.0, size=(R, S, 24)).astype(np.float32)
    want, ww = jemb.embed(kp_cfg, jnp.asarray(v), dists=jnp.asarray(v),
                          cutoff_dist=jnp.asarray(cut), tau=tau)
    tcfg, _ = temb.make_embedder(7, 24, 0, {
        'cutoff': True, 'cutoff_inputs': True, 'cutoff_dim': 24,
        'dist_inputs': False})
    got, gw = temb.embed(tcfg, _t(v), dists=_t(v), cutoff_dist=_t(cut),
                         tau=tau)
    np.testing.assert_allclose(_n(got), want, **PE)
    np.testing.assert_allclose(_n(gw), ww, **PE)
    # view: per-ray unit dirs (R, 1, 72) windowed by per-point distances
    view_cfg, _ = jemb.make_embedder(4, 72, 0, {
        'cutoff': True, 'cutoff_inputs': True, 'cutoff_dim': 24,
        'dist_inputs': True})
    tview, _ = temb.make_embedder(4, 72, 0, {
        'cutoff': True, 'cutoff_inputs': True, 'cutoff_dim': 24,
        'dist_inputs': True})
    d = rng.normal(size=(R, 1, 72)).astype(np.float32)
    want, _ = jemb.embed(view_cfg, jnp.asarray(d), dists=jnp.asarray(v),
                         cutoff_dist=jnp.asarray(cut), tau=tau)
    got, _ = temb.embed(tview, _t(d), dists=_t(v), cutoff_dist=_t(cut),
                        tau=tau)
    assert got.shape == want.shape == (R, S, 648)
    np.testing.assert_allclose(_n(got), want, **PE)


def test_embed_unported_modes_raise():
    cfg, _ = temb.make_embedder(4, 24, 0, {'cutoff': True,
                                           'cutoff_inputs': True,
                                           'freq_schedule': True})
    x = torch.zeros((2, 24))
    with pytest.raises(NotImplementedError):
        temb.embed(cfg, x, dists=x, cutoff_dist=torch.ones(24), tau=1.0)


@pytest.mark.parametrize('density_type', ['relu', 'softplus'])
def test_raw2outputs(rng, density_type):
    R, S = 16, 12
    raw = rng.normal(size=(R, S, 4)).astype(np.float32) * 2.0
    z = np.sort(rng.uniform(1.0, 4.0, size=(R, S)), -1).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    want = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                             jnp.asarray(rays_d),
                             act_fn=jcomp.get_density_fn(density_type))
    got = tcomp.raw2outputs(_t(raw), _t(z), _t(rays_d),
                            act_fn=tcomp.get_density_fn(density_type))
    for k in want:
        np.testing.assert_allclose(_n(got[k]), want[k], err_msg=k, **GEOM)


def test_sample_from_lineseg_and_pdf_det(rng):
    R = 16
    near = rng.uniform(0.5, 1.0, size=(R, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, size=(R, 1)).astype(np.float32)
    for lindisp in (False, True):
        np.testing.assert_allclose(
            _n(tsamp.sample_from_lineseg(_t(near), _t(far), 64,
                                         lindisp=lindisp)),
            jsamp.sample_from_lineseg(None, jnp.asarray(near),
                                      jnp.asarray(far), 64,
                                      lindisp=lindisp), **GEOM)
    bins = np.sort(rng.uniform(1.0, 3.0, size=(R, 63)), -1).astype(
        np.float32)
    w = rng.uniform(size=(R, 62)).astype(np.float32) ** 4
    np.testing.assert_allclose(
        _n(tsamp.sample_pdf(_t(bins), _t(w), 16, det=True)),
        jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 16,
                         det=True), **GEOM)


def test_isample_merge_ranks_with_ties(rng):
    R, S = 8, 64
    near = rng.uniform(0.5, 1.0, size=(R, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, size=(R, 1)).astype(np.float32)
    z = np.array(jsamp.sample_from_lineseg(None, jnp.asarray(near),
                                           jnp.asarray(far), S))
    z[0] = z[0, 0]                    # a degenerate ray: every z ties
    w = rng.uniform(size=(R, S)).astype(np.float32) ** 3
    want = jsamp.isample_from_lineseg(None, jnp.asarray(z), jnp.asarray(w),
                                      16, det=True)
    got = tsamp.isample_from_lineseg(_t(z), _t(w), 16, det=True)
    np.testing.assert_allclose(_n(got[0]), want[0], **GEOM)   # z_all
    np.testing.assert_allclose(_n(got[1]), want[1], **GEOM)   # z_samples
    np.testing.assert_array_equal(_n(got[2]), want[2])        # ranks
    np.testing.assert_array_equal(_n(got[2][0]), np.arange(S + 16))


def test_stable_ranks_and_scatter_rows(rng):
    z = rng.integers(0, 5, size=(6, 30)).astype(np.float32)  # many ties
    ranks = tsamp.stable_ranks(_t(z))
    np.testing.assert_array_equal(_n(ranks),
                                  jsamp.stable_ranks(jnp.asarray(z)))
    x = rng.normal(size=(6, 30, 4)).astype(np.float32)
    from anerf_tpu.ops.gather import scatter_rows as j_scatter
    np.testing.assert_array_equal(
        _n(tsamp.scatter_rows(_t(x), ranks)),
        j_scatter(jnp.asarray(x), jnp.asarray(_n(ranks))))
