"""The weight image of K1, K3 and K4 (anerf_torch/kernels/fused_render.py:
'img', the operand csrc/fused_render_sm90.cu stages in shared memory) on
the CPU.

The image holds the same bf16 blocks as the fragment-order 'w' that K1-v1,
K2, K3-v1 and K4-v1 read, each input segment padded to a multiple of 64
and cut into 64-deep k-slices in the layout wgmma reads as a K-major B
operand with the 128-byte swizzle. These tests hold the packer, its
inverse and the kernel's read order (`image_slices`, `weights_from_image`)
to the fragment-order weights and to the JAX package's parameters, bit for
bit: no tolerance, since both sides hold the same bf16 values. They also
hold the Python mirror of the kernel's shared-memory plan
(`sm90_smem_bytes`) to the kernel source, and the route a layout that
does not fit takes.
"""
import re
import dataclasses

import numpy as np
import pytest
import torch

import jax

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_mlp as tfm
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


#: K1's and K3's image widths at the flagship (nfk 7, nfv 4): 432, 664
FLAGSHIP_K = tfr.input_widths(7, 4)[0::2]


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
    shapes = tfr.sm90_shapes(ncfg, *FLAGSHIP_K)
    assert shapes[0] == (256, 448) and shapes[5] == (256, 448 + 256)
    assert shapes[-1] == (128, 256 + 704) and len(shapes) == 10
    slices = tfr.image_slices(ncfg, *FLAGSHIP_K)
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
    shapes = tfr.sm90_shapes(ncfg, *FLAGSHIP_K)
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
                                                 (3, (), 7, 4),
                                                 (8, (4,), 7, 0)])
def test_image_of_other_configs(depth, skips, nfk, nfv):
    """Other depths, skips and frequencies: X0 of 24 (1 + 2 nfk) + 72
    columns and XV of 72 (1 + 2 nfv) + 16, each padded to 64; nfv = 0 is
    the surreal_single network (XV 88 -> 128 columns)."""
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


#: K4's configs (tests/test_torch_kernels_gpu.py): the flagship, a small
#: net without bones, and widths the kernels' 16-byte copies pad to 8
K4_CONFIGS = {
    'flagship': dict(depth=8, width=256, input_ch=360, input_ch_bones=72,
                     input_ch_views=648, use_framecode=True,
                     framecode_ch=16, n_framecodes=4),
    'small': dict(depth=4, width=256, input_ch=24, input_ch_bones=0,
                  input_ch_views=72, skips=(2,), use_viewdirs=True),
    'odd_widths': dict(depth=3, width=256, input_ch=30, input_ch_bones=0,
                       input_ch_views=70, skips=(), use_viewdirs=True)}


def _k4_packed(name):
    ncfg = NeRFConfig(**K4_CONFIGS[name])
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(2), 'cpu')
    return ncfg, tfm.pack_params(params, ncfg)


@pytest.mark.parametrize('name', sorted(K4_CONFIGS))
def test_k4_image_equals_fragment_weights(name):
    """K4's image, built for widths dnet_input and view_in, read back in
    the kernel's slice order, holds the fragment-order weights."""
    ncfg, packed = _k4_packed(name)
    k0, kv = ncfg.dnet_input, tfm.view_in(ncfg)
    assert (packed['k0'], packed['kv']) == (k0, kv)
    shapes = tfr.sm90_shapes(ncfg, k0, kv)
    assert packed['img'].numel() == sum(n * k for n, k in shapes)
    got = tfr.weights_from_image(ncfg, packed)
    want = tfr._weights_f32(ncfg, packed)
    assert [tuple(w.shape) for w in got] == tfr.mlp_shapes(
        ncfg, packed['k0p'], packed['kvp'])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize('name', sorted(K4_CONFIGS))
def test_k4_image_padding_holds_no_weight(name):
    """Every column of K4's image past the live inputs of layer 0, of a
    skip layer's x0 segment and of the view layer's xv segment is zero,
    and no weight is lost: the image holds as many nonzero values as
    'w'."""
    ncfg, packed = _k4_packed(name)
    k0, kv, W = ncfg.dnet_input, tfm.view_in(ncfg), ncfg.width
    shapes = tfr.sm90_shapes(ncfg, k0, kv)
    off = 0
    for i, (n, k) in enumerate(shapes):
        blk = tfr.from_sm90_image(packed['img'][off:off + n * k], n, k)
        off += n * k
        if i == 0 or (i < ncfg.depth and (i - 1) in ncfg.skips):
            assert not blk[:, k0:shapes[0][1]].any()
        if i == len(shapes) - 1:
            assert not blk[:, W + kv:].any()
    assert torch.count_nonzero(packed['img']) == \
        torch.count_nonzero(packed['w'])


def _source_int(name, path):
    text = (tfr._CSRC / path).read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def test_smem_mirror_follows_the_kernel_source():
    """The mirror's constants are the kernel's, and its sums are the ones
    the layout gives: the flagship's 7 X0 chunks (432 and 664 columns,
    XV spilling 7 chunks past HA's start) fit with 2,000 bytes to spare;
    one more kp frequency (480 columns, 8 chunks) does not; 88 and 88
    columns take 2 chunks each, XV within X0."""
    assert tfr.SM90_STAGES == _source_int('STAGES', 'fused_render_sm90.cu')
    assert tfr.SM90_MAX_SMEM == _source_int('MAX_SMEM', 'sm90_common.cuh')
    assert tfr.KERNEL_WIDTH == _source_int('W', 'fused_render_common.cuh')
    assert tfr.SLICE_K == _source_int('KC', 'sm90_common.cuh')
    fixed = 64 * 24 * 4 + 2 * 64 * 16 + 3 * 32768 + 48 + 1024
    assert tfr.sm90_smem_bytes(*FLAGSHIP_K) == 15 * 8192 + fixed
    assert tfr.sm90_smem_bytes(*FLAGSHIP_K) == tfr.SM90_MAX_SMEM - 2000
    assert tfr.sm90_smem_bytes(88, 88) == 10 * 8192 + fixed
    assert tfr.sm90_smem_bytes(432, 704) == tfr.sm90_smem_bytes(*FLAGSHIP_K)
    k0 = tfr.input_widths(8, 4)[0]
    assert k0 == 480 and tfr.sm90_smem_bytes(k0, 664) > tfr.SM90_MAX_SMEM
    assert tfr.sm90_smem_bytes(432, 768) > tfr.SM90_MAX_SMEM


def test_layout_over_the_limit_raises_from_the_wrappers():
    """A network whose inputs do not fit K1's single kernel at three or two
    weight stages: K4's gate (JAX's) takes it and the route plan sends it
    to the layered route, saying why; on a device other than the CPU
    (here the meta device, which no kernel takes) the K1, K3 and K4
    wrappers raise before anything launches; on the CPU they run the
    plain version."""
    kw = dict(K4_CONFIGS['small'], input_ch=480)    # x0 480 columns
    ncfg = NeRFConfig(**kw)
    assert tfm.supports_config(ncfg)
    assert tfm.supports_config(NeRFConfig(**K4_CONFIGS['small']))
    assert tfr.route_plan(ncfg, 480, 72).kind == 'single'
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), 'cpu')
    packed = tfm.pack_params(params, ncfg)
    x0, xv = torch.zeros((5, 480)), torch.zeros((5, 72))
    assert tfm.fused_mlp_apply(ncfg, packed, x0, xv).shape == (5, 4)
    for fn in (tfm.fused_mlp_apply, tfm.fused_mlp_apply_v1):
        with pytest.raises(ValueError, match='no kernel'):
            fn(ncfg, packed, x0.to('meta'), xv.to('meta'))
    rcfg = NeRFConfig(depth=8, width=256, input_ch=24 * 21,
                      input_ch_bones=72, input_ch_views=936,
                      use_framecode=True, framecode_ch=32, n_framecodes=4)
    route = tfr.route_plan(rcfg, *tfr.input_widths(10, 6, 32)[0::2])
    assert route.kind == 'layered' and 'shared memory' in route.why
    assert tfr.sm90_smem_bytes(*tfr.input_widths(10, 6, 32)[0::2], 2) \
        == 238624 > tfr.SM90_MAX_SMEM
    rparams = init_nerf_params(rcfg, torch.Generator().manual_seed(0), 'cpu')
    rpacked = tfr.pack_render_params(rparams, rcfg, 10, 6,
                                     torch.full((24,), 0.5))
    x_raw = torch.zeros((2, 3, tfr.raw_width(32)), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        tfr.fused_encode_mlp(rcfg, rpacked, x_raw, 35.0)
    pts = torch.zeros((2, 3, 3), device='meta')
    m_all = torch.zeros((6, 72), device='meta')
    aux = torch.zeros((2, tfr.aux_width(32)), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        tfr.fused_encode_mlp_pts(rcfg, rpacked, pts, m_all, aux, 3, 35.0)
    assert tfr.fused_encode_mlp_pts(
        rcfg, rpacked, torch.zeros((2, 3, 3)), torch.zeros((6, 72)),
        torch.zeros((2, tfr.aux_width(32))), 3, 35.0).shape == (2, 3, 4)
