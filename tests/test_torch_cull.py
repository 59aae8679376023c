"""anerf_torch sample culling (render/raycaster.py:cull_samples) against
anerf_tpu, on the CPU.

The same numpy inputs go through both packages' cull_samples; the kept
z values and points must be the same values in the same order (the JAX
one-hot gathers are exact, so equality is exact). Cases: more in-window
samples than the budget (the evenly strided pick), fewer (padding with
the nearest out-of-window samples), tied z, a ray with no in-window
sample, and the full budget (the identity). Then render_rays with
culling in test mode on both branches, against JAX's at the render
tests' tolerance (tests/test_torch_render.py: 5e-3 abs / rel, observed
below 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_tpu.render.raycaster import cull_samples as j_cull_samples
from anerf_tpu.render.raycaster import render_rays as j_render_rays

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.render.factory import build_render_config
from anerf_torch.render.raycaster import cull_samples, render_rays
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny, synthetic_batch

LIKE = dict(atol=5e-3, rtol=5e-3)
R, S, J = 12, 24, 24


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope='module')
def cfgs():
    rng = np.random.default_rng(0)
    args, cfg, _, pose = build_tiny(rng)
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    return cfg, tcfg


def _inputs(case, seed=0):
    """(z (R, S) ascending, pts (R, S, 3), kps (R, J, 3), cutoff (J,)):
    joints on a line through the origin, points along rays that pass it
    at a random offset; `case` picks the window and the z."""
    rng = np.random.default_rng(seed)
    kps = np.zeros((R, J, 3), np.float32)
    kps[..., 0] = np.linspace(-0.6, 0.6, J, dtype=np.float32)
    kps += rng.normal(size=(R, 1, 3)).astype(np.float32) * 0.05
    z = np.sort(rng.uniform(1.0, 5.0, size=(R, S)), -1).astype(np.float32)
    if case == 'tied_z':
        z[:, 1::3] = z[:, 0::3][:, :z[:, 1::3].shape[1]]
        z = np.sort(z, -1)
    o = np.array([0.0, 0.0, 3.0], np.float32)
    d = np.stack([rng.normal(size=R) * 0.1, rng.normal(size=R) * 0.1,
                  -np.ones(R)], -1).astype(np.float32)
    if case == 'none_in_window':
        d[0, :2] = [3.0, 3.0]          # ray 0 misses every window
    pts = o + d[:, None] * z[..., None]
    cut = {'more_than_budget': 1.2, 'fewer_than_budget': 0.12,
           'tied_z': 0.5, 'none_in_window': 0.3, 'full_budget': 0.5}[case]
    cutoff = np.full((J,), cut, np.float32)
    return z, pts.astype(np.float32), kps, cutoff


def _in_window_counts(z, pts, kps, cutoff, margin):
    d2 = ((pts[:, :, None] - kps[:, None]) ** 2).sum(-1)
    cut = cutoff * (1.0 + margin)
    return (d2 < cut * cut).any(-1).sum(-1)


@pytest.mark.parametrize('case,n_keep', [
    ('more_than_budget', 8), ('fewer_than_budget', 8), ('tied_z', 8),
    ('none_in_window', 8), ('full_budget', S)])
def test_cull_samples_matches_jax(cfgs, case, n_keep):
    jcfg, tcfg = (dataclasses.replace(c, n_keep=n_keep) for c in cfgs)
    z, pts, kps, cutoff = _inputs(case)
    counts = _in_window_counts(z, pts, kps, cutoff, tcfg.cull_margin)
    if case == 'more_than_budget':
        assert (counts > n_keep).all()
    elif case == 'fewer_than_budget':
        assert (counts < n_keep).all() and counts.max() > 0
    elif case == 'none_in_window':
        assert counts[0] == 0 and counts[1:].max() > 0
    jz, jpts = j_cull_samples(jcfg, jnp.asarray(z), jnp.asarray(pts),
                              jnp.asarray(kps), jnp.asarray(cutoff))
    tz, tpts = cull_samples(tcfg, _t(z), _t(pts), _t(kps), _t(cutoff))
    assert tz.shape == (R, n_keep) and tpts.shape == (R, n_keep, 3)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tpts.numpy(), np.asarray(jpts))
    assert (np.diff(tz.numpy(), axis=-1) >= 0).all()
    if case == 'full_budget':
        np.testing.assert_array_equal(tz.numpy(), z)
        np.testing.assert_array_equal(tpts.numpy(), pts)


def test_cull_samples_pads_with_nearest_out_of_window(cfgs):
    """With fewer in-window samples than the budget every in-window sample
    is kept, and the rest of the budget is the nearest others by z."""
    tcfg = dataclasses.replace(cfgs[1], n_keep=8)
    z, pts, kps, cutoff = _inputs('fewer_than_budget')
    d2 = ((pts[:, :, None] - kps[:, None]) ** 2).sum(-1)
    cut = cutoff * (1.0 + tcfg.cull_margin)
    inside = (d2 < cut * cut).any(-1)
    tz, _ = cull_samples(tcfg, _t(z), _t(pts), _t(kps), _t(cutoff))
    for r in range(R):
        fill = 8 - inside[r].sum()
        want = np.sort(np.concatenate([z[r][inside[r]],
                                       z[r][~inside[r]][:fill]]))
        np.testing.assert_array_equal(tz[r].numpy(), want)


def test_cull_samples_gives_kps_no_gradient(cfgs):
    tcfg = dataclasses.replace(cfgs[1], n_keep=8)
    z, pts, kps, cutoff = _inputs('more_than_budget')
    k = _t(kps).requires_grad_()
    p = _t(pts).requires_grad_()
    _, kept = cull_samples(tcfg, _t(z), p, k, _t(cutoff))
    kept.sum().backward()
    assert k.grad is None
    # each kept point passes its gradient to the sample it came from
    assert p.grad.sum().item() == R * 8 * 3


@pytest.mark.parametrize('fused', [False, True])
def test_render_rays_culled_matches_jax(fused):
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16', N_samples=64, N_importance=16,
        cull_ratio=0.125)
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = (
            params[net]['alpha_linear']['b'] + 2.0)
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    assert cfg.n_keep == tcfg.n_keep == 8
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    cfg = dataclasses.replace(cfg.test_mode(), use_fused=fused)
    tcfg = dataclasses.replace(tcfg.test_mode(), use_fused=fused)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    pr = lambda k: batch[k][batch['pose_idx']]
    want = j_render_rays(params, cfg, batch['rays'], pr('kp3d'), pr('skts'),
                         pr('bones'), pr('cyls'), cam_idxs=batch['cam_idxs'],
                         rng=None, tau=jnp.float32(35.0))
    before = tfr.LAUNCHES
    got = render_rays(tparams, tcfg, _t(batch['rays']), _t(pr('kp3d')),
                      _t(pr('skts')), _t(pr('bones')), _t(pr('cyls')),
                      cam_idxs=_t(batch['cam_idxs']), tau=35.0)
    assert tfr.LAUNCHES == before      # the CPU takes the plain version
    assert float(np.asarray(want['acc_map']).max()) > 0.05
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **LIKE)
