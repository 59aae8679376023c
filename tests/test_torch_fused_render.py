"""anerf_torch K1 and K3 (kernels/fused_render.py) against anerf_tpu, on
the CPU.

On a CPU tensor the wrapper runs the kernel's plain PyTorch version, so
these tests hold the plain version (and the operand packing the CUDA
kernel reads) against the JAX Pallas kernel, run in interpret mode as
tests/test_fused_render.py runs it, and against the JAX XLA path. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.

Tolerances:
  * plain K1 or K3 vs the Pallas kernel: 5e-3 abs/rel. Both keep each
    product in f32 and round the same activations to bf16; they differ by
    the sin/cos implementation (libm vs a 3e-6 polynomial) and hi/lo-split
    vs plain f32 geometry, which flip an occasional bf16 rounding
    (observed 2.8e-4 on raw values up to ~0.2).
  * build_raw_inputs vs JAX's: 1e-6 abs, f32 rounding of the same
    geometry.
  * plain K1 vs JAX encode_inputs + run_network: 3e-2, the bound the JAX
    package's own fused-vs-XLA tests use (XLA rounds each layer's
    product to bf16 before the bias add).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_tpu.kernels import fused_render as jfr
from anerf_tpu.models.nerf import lookup_framecodes
from anerf_tpu.render.raycaster import encode_inputs, run_network

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.render.factory import build_render_config
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny, synthetic_batch

LIKE = dict(atol=5e-3, rtol=5e-3)
CROSS = dict(atol=3e-2, rtol=3e-2)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope='module')
def setup():
    """Flagship embedder at width 256 / depth 8, 16 rays x 6 samples."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16')
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    rays_o, rays_d = batch['rays'][:, :3], batch['rays'][:, 3:6]
    S = 6
    z = jnp.linspace(1.0, 3.0, S)
    pts = rays_o[:, None] + rays_d[:, None] * z[None, :, None]
    skts = batch['skts'][batch['pose_idx']]
    fc = lookup_framecodes(params['coarse'], batch['cam_idxs'])
    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams,
                batch=batch, pts=pts, rays_d=rays_d, skts=skts, fc=fc, S=S)


def _torch_operands(s):
    packed = tfr.pack_render_params(
        s['tparams']['coarse'], s['tcfg'].nerf, 7, 4,
        s['tparams']['cutoff_dist'])
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], _t(s['skts']),
                                   _t(s['fc']))
    return packed, m_all, aux


def test_supported_gate_matches_jax(setup):
    assert tfr.fused_render_supported(setup['tcfg'])
    assert jfr.fused_render_supported(setup['cfg'])
    assert not tfr.fused_render_supported(
        dataclasses.replace(setup['tcfg'], kp_dist_type='relpos'))


def test_pack_ray_data_matches_jax(setup):
    s = setup
    jm, ja = jfr.pack_ray_data(s['rays_d'][:, None], s['skts'], s['fc'])
    _, m_all, aux = _torch_operands(s)
    R, SEG = m_all.shape[0] // 3, jfr.SEG
    np.testing.assert_array_equal(
        m_all.numpy(), np.asarray(jm)[:, :72])
    ja = np.asarray(ja).reshape(R, 3, SEG)
    np.testing.assert_array_equal(aux[:, :72].numpy(), ja[:, 0, :72])
    np.testing.assert_allclose(aux[:, 72:144].numpy(), ja[:, 1, :72],
                               atol=1e-6, rtol=0)   # rsqrt ulps
    np.testing.assert_array_equal(aux[:, 144:].numpy(), ja[:, 2, :16])


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_plain_k1_matches_pallas(setup, tau):
    s = setup
    jpacked = jfr.pack_render_params(s['params']['coarse'], s['cfg'].nerf,
                                     7, 4, s['params']['cutoff_dist'])
    jm, ja = jfr.pack_ray_data(s['rays_d'][:, None], s['skts'], s['fc'])
    want = jfr.fused_encode_mlp_pts(s['cfg'].nerf, jpacked, s['pts'], jm,
                                    ja, s['S'], jnp.float32(tau))
    packed, m_all, aux = _torch_operands(s)
    got = tfr.fused_encode_mlp_pts_ref(s['tcfg'].nerf, packed, _t(s['pts']),
                                       m_all, aux, s['S'], tau)
    assert got.shape == (16, s['S'], 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LIKE)


def test_plain_k1_matches_xla_path(setup):
    s = setup
    tau = jnp.float32(35.0)
    pr = lambda k: s['batch'][k][s['batch']['pose_idx']]
    enc = encode_inputs(s['cfg'], s['pts'], s['rays_d'][:, None],
                        pr('kp3d'), s['skts'], pr('bones'),
                        s['params']['cutoff_dist'], tau, None)
    want = run_network(s['cfg'], s['params']['coarse'], enc, s['fc'])
    packed, m_all, aux = _torch_operands(s)
    got = tfr.fused_encode_mlp_pts_ref(s['tcfg'].nerf, packed, _t(s['pts']),
                                       m_all, aux, s['S'], 35.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CROSS)


def test_wrapper_takes_plain_route_on_cpu(setup):
    s = setup
    packed, m_all, aux = _torch_operands(s)
    pts = _t(s['pts'])
    before = tfr.LAUNCHES
    got = tfr.fused_encode_mlp_pts(s['tcfg'].nerf, packed, pts, m_all, aux,
                                   s['S'], 35.0)
    assert tfr.LAUNCHES == before == 0
    want = tfr.fused_encode_mlp_pts_ref(s['tcfg'].nerf, packed, pts, m_all,
                                        aux, s['S'], 35.0)
    assert torch.equal(got, want)


def test_packed_layout_matches_layer_shapes(setup):
    s = setup
    packed, _, _ = _torch_operands(s)
    ncfg = s['tcfg'].nerf
    shapes = tfr.layer_shapes(ncfg, 7, 4)
    assert shapes[0] == (256, 432) and shapes[5] == (256, 688)
    assert shapes[-1] == (128, 256 + 672)       # view input 664 -> 672
    assert packed['w'].numel() == sum(n * k for n, k in shapes)
    assert packed['w'].dtype == torch.bfloat16
    assert packed['b'].numel() == 256 * 9 + 128
    # the view block's zero-padded columns hold no weight
    off = sum(n * k for n, k in shapes[:-1])
    view = tfr.from_fragment_order(packed['w'][off:], 128, 928)
    assert not view[:, 256 + 664:].any()
    want = s['tparams']['coarse']['views_linears'][0]['w'].t()
    assert torch.equal(view[:, :256 + 664], want.to(torch.bfloat16))


def test_fragment_order_is_the_mma_b_fragment():
    """Each lane's 16 bytes are the m16n8k16 B fragments {b0, b1} of an
    even and an odd n-tile, as the kernel's load_b unpacks them."""
    N, K = 32, 48
    w = torch.arange(N * K).reshape(N, K)
    flat = tfr.to_fragment_order(w)
    assert torch.equal(tfr.from_fragment_order(flat, N, K), w)
    for ks in range(K // 16):
        for pair in range(N // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                got = flat[((ks * (N // 16) + pair) * 32 + lane) * 8:][:8]
                want = [w[16 * pair + 8 * half + g, 16 * ks + 2 * t + hi + e]
                        for half in (0, 1) for hi in (0, 8) for e in (0, 1)]
                assert got.tolist() == [int(x) for x in want]


def _raw_inputs(s):
    return tfr.build_raw_inputs(_t(s['pts']), _t(s['rays_d'])[:, None],
                                _t(s['skts']), _t(s['fc']))


@pytest.mark.parametrize('with_fc', [True, False])
def test_build_raw_inputs_matches_jax(setup, with_fc):
    """The port's (R, S, 184) rows against JAX's (R, S, 512) segments
    [v | r | d | fc], each 128 lanes wide with its live lanes first."""
    s = setup
    fc = s['fc'] if with_fc else None
    want = np.asarray(jfr.build_raw_inputs(s['pts'], s['rays_d'][:, None],
                                           s['skts'], fc))
    got = tfr.build_raw_inputs(_t(s['pts']), _t(s['rays_d'])[:, None],
                               _t(s['skts']),
                               None if fc is None else _t(fc)).numpy()
    assert got.shape == (16, s['S'], tfr.RAW_W) and got.dtype == np.float32
    SEG = jfr.SEG
    lanes = np.concatenate([np.arange(24), SEG + np.arange(72),
                            2 * SEG + np.arange(72), 3 * SEG + np.arange(16)])
    np.testing.assert_allclose(got, want[..., lanes], atol=1e-6, rtol=0)
    assert not np.any(np.delete(want, lanes, axis=-1))


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_plain_k3_matches_pallas(setup, tau):
    """K3's plain version against the JAX fused_encode_mlp, run in
    interpret mode as tests/test_fused_render.py:184 runs it."""
    s = setup
    jpacked = jfr.pack_render_params(s['params']['coarse'], s['cfg'].nerf,
                                     7, 4, s['params']['cutoff_dist'])
    x = jfr.build_raw_inputs(s['pts'], s['rays_d'][:, None], s['skts'],
                             s['fc'])
    R, S = x.shape[:2]
    want = jfr.fused_encode_mlp(s['cfg'].nerf, jpacked,
                                x.reshape(R * S, -1), 256, jnp.float32(tau))
    packed, _, _ = _torch_operands(s)
    got = tfr.fused_encode_mlp_ref(s['tcfg'].nerf, packed, _raw_inputs(s),
                                   tau)
    assert got.shape == (R, S, 4)
    np.testing.assert_allclose(got.numpy().reshape(R * S, 4),
                               np.asarray(want), **LIKE)


def test_plain_k3_matches_plain_k1(setup):
    """K3 on build_raw_inputs of K1's points computes K1's function: the
    plain versions agree up to f32 rounding of the geometry."""
    s = setup
    packed, m_all, aux = _torch_operands(s)
    got = tfr.fused_encode_mlp_ref(s['tcfg'].nerf, packed, _raw_inputs(s),
                                   35.0)
    want = tfr.fused_encode_mlp_pts_ref(s['tcfg'].nerf, packed, _t(s['pts']),
                                        m_all, aux, s['S'], 35.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LIKE)


def test_k3_wrapper_takes_plain_route_on_cpu(setup):
    s = setup
    packed, _, _ = _torch_operands(s)
    x = _raw_inputs(s)
    before = tfr.RAW_LAUNCHES
    got = tfr.fused_encode_mlp(s['tcfg'].nerf, packed, x, 35.0)
    assert tfr.RAW_LAUNCHES == before == 0
    assert torch.equal(got, tfr.fused_encode_mlp_ref(s['tcfg'].nerf, packed,
                                                     x, 35.0))
