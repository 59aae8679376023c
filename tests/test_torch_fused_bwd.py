"""anerf_torch K2 (kernels/fused_render.py:fused_bwd) against anerf_tpu, on
the CPU.

On a CPU tensor `fused_bwd` runs its plain PyTorch version, so these
tests hold the plain version, the parameter-leaf mapping of `FusedApply`
and the operand packing against the JAX `fused_apply` VJP (the Pallas
backward kernel in interpret mode, as tests/test_fused_render.py runs
it) and against torch.autograd through K1's plain version. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.

Tolerances (setup of tests/test_fused_render.py:45-125: width 256,
depth 8, 16 rays x 6 samples):
  * against the JAX VJP: pts, skts and framecodes 2e-2 relative max
    (observed <= 1.4e-2); each parameter leaf 2e-2 relative in the
    Frobenius norm (observed <= 1.2e-2) and 0.12 relative max (observed
    <= 0.05). The two forwards round their activations to bf16 after f32
    sums in another order (and the JAX kernel's sin/cos is a 3e-6
    polynomial), so an occasional ReLU mask flips; one flipped unit moves
    a single weight-gradient entry by its full cotangent. 0.12 is the
    bound the JAX package's own fused-vs-XLA gradient test uses for the
    same effect (tests/test_fused_render.py:260).
  * against autograd through K1's plain version: 2e-2 relative max
    (observed <= 7.4e-3). Autograd rounds every cotangent to bf16 at the
    casts; K2 keeps them f32, with the same masks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_tpu.kernels import fused_render as jfr
from anerf_tpu.models.nerf import lookup_framecodes

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.render.factory import build_render_config
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny, synthetic_batch

R, S = 16, 6


def _t(x):
    return torch.as_tensor(np.array(x))


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-7)


def _relfro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-7)


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16')
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    batch = synthetic_batch(rng, pose, n_rays=R, n_images=4)
    rays_o, rays_d = batch['rays'][:, :3], batch['rays'][:, 3:6]
    pts = rays_o[:, None] + rays_d[:, None] * jnp.linspace(1.0, 3.0, S)[
        None, :, None]
    gw = np.random.default_rng(7).normal(size=(R, S, 4)).astype(np.float32)
    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams,
                batch=batch, pts=pts, rays_d=rays_d, gw=gw,
                skts=batch['skts'][batch['pose_idx']])


def _jax_grads(s, tau):
    """JAX fused_apply VJP w.r.t. the net's param tree, pts, skts and the
    framecodes, through pack_render_params / pack_ray_data."""
    cfg, params = s['cfg'], s['params']
    net = {k: v for k, v in params['coarse'].items() if k != 'framecodes'}
    cams = s['batch']['cam_idxs']

    def loss(p, pts, skts, codes):
        full = dict(p, framecodes={'codes': codes})
        fc = lookup_framecodes(full, cams)
        packed = jfr.pack_render_params(full, cfg.nerf, 7, 4,
                                        params['cutoff_dist'])
        m_all, aux = jfr.pack_ray_data(s['rays_d'][:, None], skts, fc)
        out = jfr.fused_apply(cfg.nerf, S, True, packed, pts, m_all, aux,
                              jnp.float32(tau))
        return jnp.sum(out * s['gw'])

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        net, s['pts'], s['skts'], params['coarse']['framecodes']['codes'])


def _torch_grads(s, tau, through_kernel_path=True):
    """Gradients of sum(raw * gw) w.r.t. the same inputs on the port:
    through fused_apply (K2's plain version on the CPU), or through
    autograd on K1's plain version."""
    tcfg, tnet = s['tcfg'], s['tparams']['coarse']
    leaves = [x.clone().requires_grad_()
              for x in tfr._net_leaves(tcfg.nerf, tnet)]
    pts = _t(s['pts']).requires_grad_()
    skts = _t(s['skts']).requires_grad_()
    codes = tnet['framecodes']['codes'].clone().requires_grad_()
    fc = codes[_t(s['batch']['cam_idxs']).long()]
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], skts, fc)
    net = tfr._net_from_leaves(tcfg.nerf, leaves)
    cut = s['tparams']['cutoff_dist']
    if through_kernel_path:
        out = tfr.fused_apply(tcfg.nerf, S, net, cut, 7, 4, pts, m_all,
                              aux, tau)
    else:
        packed = tfr.pack_render_params(net, tcfg.nerf, 7, 4, cut)
        out = tfr.fused_encode_mlp_pts_ref(tcfg.nerf, packed, pts, m_all,
                                           aux, S, tau)
    (out * _t(s['gw'])).sum().backward()
    return [x.grad for x in leaves], pts.grad, skts.grad, codes.grad


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_fused_bwd_matches_jax_vjp(setup, tau):
    s = setup
    jg = _jax_grads(s, tau)
    leaves, dpts, dskts, dcodes = _torch_grads(s, tau)
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


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_fused_bwd_matches_autograd_of_plain_k1(setup, tau):
    s = setup
    got = _torch_grads(s, tau)
    want = _torch_grads(s, tau, through_kernel_path=False)
    for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert _relmax(b.numpy(), a.numpy()) < 2e-2


def test_fused_bwd_wrapper_takes_plain_route_on_cpu(setup):
    s = setup
    ncfg = s['tcfg'].nerf
    packed = tfr.pack_render_params(s['tparams']['coarse'], ncfg, 7, 4,
                                    s['tparams']['cutoff_dist'])
    fc = s['tparams']['coarse']['framecodes']['codes'][
        _t(s['batch']['cam_idxs']).long()]
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], _t(s['skts']),
                                   fc)
    before = tfr.BWD_LAUNCHES
    got = tfr.fused_bwd(ncfg, packed, _t(s['pts']), m_all, aux, S, 35.0,
                        _t(s['gw']))
    assert tfr.BWD_LAUNCHES == before == 0
    want = tfr.fused_bwd_ref(ncfg, packed, _t(s['pts']), m_all, aux, S,
                             35.0, _t(s['gw']))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    dW, dpts, dm, daux = got
    assert dpts.shape == (R, S, 3) and dm.shape == (R * 3, 72)
    assert daux.shape == (R, 160)
    blocks = tfr.split_grads(ncfg, 7, 4, dW)
    assert [(k, tuple(v.shape)) for k, v in blocks.items()][:2] == [
        ('l0', (433, 256)), ('l1', (257, 256))]
    assert blocks['l5'].shape == (432 + 256 + 1, 256)      # skip layer
    assert blocks['view'].shape == (256 + 672 + 1, 128)
    # the zero-padded view input columns carry zero activations, so
    # their weight-gradient rows are exactly zero
    assert not blocks['view'][256 + 664:256 + 672].any()


def test_fused_apply_gives_cutoff_and_tau_no_gradient(setup):
    s = setup
    ncfg = s['tcfg'].nerf
    cut = s['tparams']['cutoff_dist'].clone().requires_grad_()
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], _t(s['skts']),
                                   None)
    pts = _t(s['pts']).requires_grad_()
    out = tfr.fused_apply(ncfg, S, s['tparams']['coarse'], cut, 7, 4,
                          pts, m_all, aux, 35.0)
    out.sum().backward()
    assert cut.grad is None and pts.grad is not None
