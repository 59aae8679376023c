"""K1's and K2's CUDA kernels against their plain PyTorch versions, on
the card.

Needs a CUDA device and nvcc; skips elsewhere. This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
Tolerances:
  * K1, 2e-3 abs/rel: the kernel and its plain version round the same
    activations to bf16 and differ by fp32 summation order and sin/cos
    ulps (observed 5e-4 abs at the flagship width on an H100).
  * K2: dpts, dm_all and daux 2e-2 relative max (denominator floored
    at 1e-7), the JAX kernel-vs-oracle bound
    (tests/test_fused_render.py:119); each weight-gradient block 2e-2
    relative in the Frobenius norm and 0.12 relative max. K2's recompute
    and the plain version can round an activation to another bf16 value
    and so flip a ReLU mask, which moves single weight-gradient entries
    by one point's whole contribution (observed 2.4e-2 relative max on a
    block at R = 40, S = 64 on an H100); the f32 products differ only by
    summation order. Two launches on the same inputs agree bit for bit.
"""
import numpy as np
import pytest
import torch

from anerf_torch.kernels import fused_render as fr
from anerf_torch.models.nerf import NeRFConfig, init_nerf_params
from anerf_torch.ops.rotations import axisang_to_rot


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(dev, R, S, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pts = f(rng.normal(size=(R, S, 3)) * 0.4)
    skts = torch.zeros((R, 24, 4, 4), device=dev)
    skts[..., :3, :3] = axisang_to_rot(f(rng.normal(size=(R, 24, 3))))
    skts[..., :3, 3] = f(rng.normal(size=(R, 24, 3)) * 0.3)
    skts[..., 3, 3] = 1.0
    m_all, aux = fr.pack_ray_data(f(rng.normal(size=(R, 1, 3))), skts,
                                  f(rng.normal(size=(R, 16))))
    return pts, m_all, aux


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(1, 64, 35.0), (3, 7, 2000.0),
                                     (512, 80, 2000.0)])
def test_k1_kernel_matches_plain(cuda, R, S, tau):
    ncfg = NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), cuda)
    packed = fr.pack_render_params(params, ncfg, 7, 4,
                                   torch.full((24,), 0.5, device=cuda))
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    before = fr.LAUNCHES
    got = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == before + 1
    want = fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S, tau)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


def _rel(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-7)).item()


def _rel_fro(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-7)).item()


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (40, 64, 2000.0)])
def test_k2_kernel_matches_plain_and_is_deterministic(cuda, R, S, tau):
    ncfg = NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(1), cuda)
    params['alpha_linear']['b'] += 1.0
    packed = fr.pack_render_params(params, ncfg, 7, 4,
                                   torch.full((24,), 0.5, device=cuda))
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    before = fr.BWD_LAUNCHES
    got = fr.fused_bwd(ncfg, packed, pts, m_all, aux, S, tau, g)
    again = fr.fused_bwd(ncfg, packed, pts, m_all, aux, S, tau, g)
    torch.cuda.synchronize()
    assert fr.BWD_LAUNCHES == before + 2
    want = fr.fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g)
    blocks = fr.split_grads(ncfg, 7, 4, got[0])
    for name, ref in fr.split_grads(ncfg, 7, 4, want[0]).items():
        assert _rel_fro(blocks[name], ref) < 2e-2, name
        assert _rel(blocks[name], ref) < 0.12, name
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) < 2e-2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
