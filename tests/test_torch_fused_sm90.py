"""K1's weight image (anerf_torch/kernels/fused_render.py: 'img', the
operand csrc/fused_render_sm90.cu stages in shared memory) on the CPU.

The image holds the same bf16 blocks as the fragment-order 'w' that K1-v1,
K2, K3 and K4 read, each input segment padded to a multiple of 64 and cut
into 64-deep k-slices in the layout wgmma reads as a K-major B operand with
the 128-byte swizzle. These tests hold the packer, its inverse and the
kernel's read order (`image_slices`, `weights_from_image`) to the
fragment-order weights and to the JAX package's parameters, bit for bit:
no tolerance, since both sides hold the same bf16 values.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.models.nerf import NeRFConfig, init_nerf_params
from anerf_torch.render.factory import build_render_config
from anerf_torch.skeleton import SMPLSkeleton

from helpers import build_tiny


def _flagship_ncfg():
    return NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)


@pytest.fixture(scope='module')
def flagship():
    ncfg = _flagship_ncfg()
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), 'cpu')
    params['alpha_linear']['b'] += 1.0
    packed = tfr.pack_render_params(params, ncfg, 7, 4,
                                    torch.full((24,), 0.5))
    return ncfg, params, packed


def _swizzled_offset(n, k, N):
    """The element offset csrc/fused_render_sm90.cu's `swz` gives (row n,
    column k) of a block of N rows: 64-column chunks of N rows x 128
    bytes, the 16-byte group k // 8 of row n stored at (k // 8) ^ (n % 8)."""
    return ((k // 64) * N * 64 + n * 64 + (((k // 8) % 8) ^ (n % 8)) * 8
            + k % 8)


@pytest.mark.parametrize('N,K', [(256, 448), (256, 256), (256, 704),
                                 (128, 960), (8, 64)])
def test_image_round_trips_every_flagship_block(N, K):
    """Layer 0 (432 padded to 448), the trunk, the 688-deep skip layer
    (448 + 256), the view layer (256 + 672 padded to 704) and the
    smallest block."""
    w = torch.arange(N * K, dtype=torch.int32).reshape(N, K)
    flat = tfr.to_sm90_image(w)
    assert flat.shape == (N * K,)
    assert torch.equal(tfr.from_sm90_image(flat, N, K), w)
    assert torch.equal(torch.sort(flat).values, w.reshape(-1))


def test_image_layout_is_the_kernel_swizzle():
    N, K = 24, 128
    w = torch.arange(N * K, dtype=torch.int32).reshape(N, K)
    flat = tfr.to_sm90_image(w)
    n, k = np.meshgrid(np.arange(N), np.arange(K), indexing='ij')
    idx = torch.as_tensor(_swizzled_offset(n, k, N).reshape(-1))
    assert torch.equal(flat[idx], w.reshape(-1))


def test_flagship_shapes_and_slices_are_16_byte_aligned(flagship):
    ncfg, _, packed = flagship
    shapes = tfr.sm90_shapes(ncfg, 7, 4)
    assert shapes[0] == (256, 448) and shapes[5] == (256, 448 + 256)
    assert shapes[-1] == (128, 256 + 704) and len(shapes) == 10
    slices = tfr.image_slices(ncfg, 7, 4)
    assert len(slices) == 7 + 6 * 4 + 11 + 4 + 15
    off = 0
    for layer, s, o, nbytes in slices:
        assert o == off and o % 16 == 0 and nbytes % 16 == 0
        assert nbytes == 2 * shapes[layer][0] * tfr.SLICE_K
        off += nbytes
    assert off == 2 * packed['img'].numel()
    assert packed['img'].dtype == torch.bfloat16
    assert packed['img'].numel() == sum(n * k for n, k in shapes)


def test_weights_from_image_equal_fragment_weights(flagship):
    ncfg, _, packed = flagship
    got = tfr.weights_from_image(ncfg, packed)
    want = tfr._weights_f32(ncfg, packed)
    assert [tuple(w.shape) for w in got] == tfr.layer_shapes(ncfg, 7, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_image_padding_holds_no_weight(flagship):
    ncfg, _, packed = flagship
    shapes = tfr.sm90_shapes(ncfg, 7, 4)
    off = sum(n * k for n, k in shapes[:-1])
    view = tfr.from_sm90_image(packed['img'][off:], 128, 960)
    assert not view[:, 256 + 664:].any()
    layer0 = tfr.from_sm90_image(packed['img'][:256 * 448], 256, 448)
    assert not layer0[:, 432:].any()


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_plain_k1_from_image_gives_the_same_bits(flagship, tau):
    """The plain version fed the weights read back from the image in the
    kernel's slice order gives the same bits as fed from 'w'."""
    ncfg, _, packed = flagship
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.normal(size=(2, 5, 432)), dtype=torch.float32)
    xv = torch.as_tensor(rng.normal(size=(2, 5, 672)), dtype=torch.float32)
    x0, xv = x0.to(torch.bfloat16).float(), xv.to(torch.bfloat16).float()
    want = tfr.mlp_trace(ncfg, packed, x0, xv)['out']
    got = tfr.mlp_trace(ncfg, packed, x0, xv,
                        ws=tfr.weights_from_image(ncfg, packed))['out']
    assert torch.equal(got, want)


@pytest.mark.parametrize('depth,skips,nfk,nfv', [(4, (2,), 5, 3),
                                                 (3, (), 7, 4)])
def test_image_of_other_configs(depth, skips, nfk, nfv):
    """Other depths, skips and frequencies: X0 of 24 (1 + 2 nfk) + 72
    columns and XV of 72 (1 + 2 nfv) + 16, each padded to 64."""
    ncfg = NeRFConfig(depth=depth, width=256, input_ch=24 * (1 + 2 * nfk),
                      input_ch_bones=72, input_ch_views=72 * (1 + 2 * nfv),
                      skips=skips, use_framecode=True, framecode_ch=16,
                      n_framecodes=2)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(1), 'cpu')
    packed = tfr.pack_render_params(params, ncfg, nfk, nfv,
                                    torch.full((24,), 0.5))
    got = tfr.weights_from_image(ncfg, packed)
    assert all(torch.equal(a, b)
               for a, b in zip(got, tfr._weights_f32(ncfg, packed)))


def test_image_holds_the_jax_weights():
    """The image built from JAX's flagship-width params (converted as the
    port converts checkpoints) holds each layer's weights, bf16-rounded,
    at their places."""
    rng = np.random.default_rng(0)
    args, cfg, params, pose = build_tiny(
        rng, netwidth=256, netdepth=8, multires=7, multires_views=4,
        compute_dtype='bfloat16')
    tcfg = build_render_config(
        TorchTrainConfig(**dataclasses.asdict(args)),
        {'skel_type': SMPLSkeleton, 'n_views': pose['kp3d'].shape[0]})
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), 'cpu')
    ncfg = tcfg.nerf
    packed = tfr.pack_render_params(tparams['coarse'], ncfg, 7, 4,
                                    tparams['cutoff_dist'])
    ws = tfr.weights_from_image(ncfg, packed)
    jp = jax.tree.map(np.asarray, params['coarse'])
    bf = lambda a: torch.as_tensor(np.array(a)).to(torch.bfloat16).float()
    dnet = ncfg.dnet_input
    assert torch.equal(ws[0][:, :dnet], bf(jp['pts_linears'][0]['w']).t())
    for i in range(1, ncfg.depth):
        w = bf(jp['pts_linears'][i]['w']).t()
        if (i - 1) in ncfg.skips:
            assert torch.equal(ws[i][:, :dnet], w[:, :dnet])
            assert torch.equal(ws[i][:, packed['k0p']:], w[:, dnet:])
        else:
            assert torch.equal(ws[i], w)
    assert torch.equal(ws[ncfg.depth], bf(jp['feature_linear']['w']).t())
    vw = bf(jp['views_linears'][0]['w']).t()
    assert torch.equal(ws[-1][:, :vw.shape[1]], vw)
