"""anerf_torch render path against anerf_tpu, on the CPU.

The same TrainConfig builds both RenderConfigs, the JAX parameters are
carried across with params_from_numpy, and both packages render in test
mode (perturb 0, no noise, deterministic importance samples).

Tolerance 5e-3 abs/rel on rgb / acc / disp for like-with-like branches
(observed ~1e-4): the fused branches differ by sin/cos implementation and
hi/lo-split vs plain f32 geometry, the plain branches by fp32 summation
order, and either can flip an occasional bf16 activation rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_tpu.render import modes as jmodes
from anerf_tpu.render.raycaster import render_rays as j_render_rays
from anerf_tpu.render.render_path import render_path as j_render_path

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy, params_to_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.render import modes as tmodes
from anerf_torch.render.factory import build_render_config
from anerf_torch.render.factory import init_render_params
from anerf_torch.render.raycaster import render_rays as t_render_rays
from anerf_torch.render.render_path import render_path as t_render_path
from anerf_torch.utils import trace
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny, synthetic_batch

LIKE = dict(atol=5e-3, rtol=5e-3)


def _t(x):
    return torch.as_tensor(np.array(x))


def _wake_density(params):
    """Random-init ReLU density can be dead everywhere; bias both density
    heads positive so the comparisons see real compositing."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    for net in ('coarse', 'fine'):
        if params.get(net) is not None:
            params[net]['alpha_linear']['b'] = (
                params[net]['alpha_linear']['b'] + 2.0)
    return params


def _build(**overrides):
    rng = np.random.default_rng(0)
    kw = dict(netwidth=256, netdepth=8, multires=7, multires_views=4,
              compute_dtype='bfloat16')
    kw.update(overrides)
    args, cfg, params, pose = build_tiny(rng, **kw)
    params = _wake_density(params)
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    return rng, args, cfg, params, pose, tcfg, tparams


def test_build_render_config_matches_jax():
    _, _, cfg, _, _, tcfg, _ = _build()
    nested = ('nerf', 'embed_kp', 'embed_bone', 'embed_view', 'skel')
    for name in nested:
        assert dataclasses.asdict(getattr(tcfg, name)) == \
            dataclasses.asdict(getattr(cfg, name)), name
    for f in dataclasses.fields(cfg):
        if f.name not in nested:
            assert getattr(tcfg, f.name) == getattr(cfg, f.name), f.name


@pytest.mark.parametrize('fused', [False, True])
def test_render_rays_matches_jax(fused):
    rng, _, cfg, params, pose, tcfg, tparams = _build()
    cfg = dataclasses.replace(cfg.test_mode(), use_fused=fused)
    tcfg = dataclasses.replace(tcfg.test_mode(), use_fused=fused)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    pr = lambda k: batch[k][batch['pose_idx']]
    want = j_render_rays(params, cfg, batch['rays'], pr('kp3d'), pr('skts'),
                         pr('bones'), pr('cyls'), cam_idxs=batch['cam_idxs'],
                         rng=None, tau=jnp.float32(35.0))
    before = tfr.LAUNCHES
    got = t_render_rays(tparams, tcfg, _t(batch['rays']), _t(pr('kp3d')),
                        _t(pr('skts')), _t(pr('bones')), _t(pr('cyls')),
                        cam_idxs=_t(batch['cam_idxs']), tau=35.0)
    assert tfr.LAUNCHES == before      # the CPU takes the plain version
    assert float(np.asarray(want['acc_map']).max()) > 0.05
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **LIKE)


@pytest.fixture(scope='module')
def bullet_view():
    """The fused flagship-width nets, 16 + 8 samples, and one 32x32 view
    of a 4-view bullet-time orbit in both packages' data: (cfg, params,
    jdata, tcfg, tparams, tdata, view, hwf, render_path's kwargs)."""
    _, args, cfg, params, pose, tcfg, tparams = _build(
        N_samples=16, N_importance=8, fused_kernel=True)
    kp = pose['kp3d']
    c2ws = np.tile(np.eye(4, dtype=np.float32), (len(kp), 1, 1))
    c2ws[:, :3, 3] = kp[:, 0] + [0.0, 0.0, 2.5]
    src_kw = dict(kps=kp, bones=pose['bones'], c2ws=c2ws,
                  focals=np.full((len(kp),), 60.0, np.float32),
                  rest_pose=pose['rest_pose'])
    jdata = jmodes.load_bullettime(jmodes.PoseSource(**src_kw),
                                   np.array([0]), n_bullet=4)
    tdata = tmodes.load_bullettime(tmodes.PoseSource(**src_kw),
                                   np.array([0]), n_bullet=4)
    view = slice(1, 2)          # one 32x32 view of the orbit
    kw = dict(cam_idxs=tdata['cam_idxs'][view], tau=2000.0, chunk=128,
              white_bkgd=True, use_framecode_idx=True)
    hwf = (32, 32, tdata['focals'][view])
    return cfg, params, jdata, tcfg, tparams, tdata, view, hwf, kw


def test_render_path_bullet_view_matches_jax(bullet_view):
    cfg, params, jdata, tcfg, tparams, tdata, view, hwf, kw = bullet_view
    assert cfg.use_fused and tcfg.use_fused
    for k in jdata:
        np.testing.assert_array_equal(tdata[k], jdata[k], err_msg=k)
    want = j_render_path(params, cfg, jdata['c2ws'][view], hwf,
                         jdata['kp3d'][view], jdata['skts'][view],
                         jdata['bones'][view], **kw)
    got = t_render_path(tparams, tcfg, tdata['c2ws'][view], hwf,
                        tdata['kp3d'][view], tdata['skts'][view],
                        tdata['bones'][view], **kw)
    np.testing.assert_array_equal(got['bboxes'], want['bboxes'])
    tl, br = want['bboxes'][0]
    assert (br[0] - tl[0]) * (br[1] - tl[1]) > 128   # more than one bucket
    assert want['accs'].max() > 0.05
    for k in ('rgbs', 'accs', 'disps'):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LIKE)


def test_render_path_spans_form_the_request_tree(bullet_view):
    """One render_path call yields the render spans (utils/trace.py) in
    their tree: the request a root counting the box rays; the pack, each
    bucket and the fetch under it; each bucket's K1 launches under it."""
    _, _, _, tcfg, tparams, tdata, view, hwf, kw = bullet_view
    trace.take()
    trace.enable()
    try:
        got = t_render_path(tparams, tcfg, tdata['c2ws'][view], hwf,
                            tdata['kp3d'][view], tdata['skts'][view],
                            tdata['bones'][view], **kw)
    finally:
        trace.disable()
    by = {}
    for r in trace.take():
        by.setdefault(r.name, []).append(r)
    (req,), (fetch,) = by['anerf.render.request'], by['anerf.render.fetch']
    (tl, br), = got['bboxes']
    box = int((br[0] - tl[0]) * (br[1] - tl[1]))
    assert req.parent is None and req.n == box
    buckets = by['anerf.render.bucket']
    assert len(buckets) == -(-box // 128) > 1
    assert {r.n for r in buckets} == {128}
    assert len(by['anerf.fused.pack']) == 2          # coarse and fine
    assert len(by['anerf.fused.k1']) == 2 * len(buckets)
    ids = {r.id for r in buckets}
    for r in by['anerf.fused.pack'] + buckets + [fetch]:
        assert r.parent == req.id and r.root == req.id
    assert all(r.parent in ids and r.root == req.id
               for r in by['anerf.fused.k1'])
    assert set(by) == {'anerf.render.request', 'anerf.render.bucket',
                       'anerf.render.fetch', 'anerf.fused.pack',
                       'anerf.fused.k1'}


def test_params_from_numpy_round_trip():
    _, _, _, params, _, _, tparams = _build(netwidth=32, netdepth=2,
                                            multires=3, multires_views=2,
                                            compute_dtype='float32')
    back = params_to_numpy(tparams)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert tparams['fine']['pts_linears'][0]['w'].shape == \
        params['fine']['pts_linears'][0]['w'].shape


def test_init_render_params_schema_and_device():
    _, args, cfg, params, _, tcfg, _ = _build()
    if torch.cuda.is_available():
        pytest.skip('checks the no-GPU refusal')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_render_params(args, tcfg, torch.Generator().manual_seed(0))
    got = init_render_params(args, tcfg, torch.Generator().manual_seed(0),
                             device='cpu')
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape), got) == shapes
    again = init_render_params(args, tcfg, torch.Generator().manual_seed(0),
                               device='cpu')
    assert torch.equal(got['fine']['views_linears'][0]['w'],
                       again['fine']['views_linears'][0]['w'])
