"""K2's split-bf16 products and its operand layouts on the CPU
(anerf_torch/kernels/fused_render.py: split3_ref, split_product_ref,
split_gemm_probe's plain version, the W^T image and the saved-activation
layout that csrc/fused_render_bwd_sm90.cu reads; kernels/roofline.py's
K2 bound).

An f32 cotangent splits exactly into three bf16 terms, so the split
product differs from an exact product only by its f32 accumulation:
these tests hold the split to exactness (no tolerance) and the plain
split product to an f64 matmul within 2e-6 relative in the Frobenius
norm (an f32 matmul of these shapes is off by about 1e-7 to 3e-7).
The images hold the same bf16 values as 'w' and the JAX weights, so
those comparisons are bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.kernels import roofline
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
    packed = tfr.pack_render_params(params, ncfg, 7, 4,
                                    torch.full((24,), 0.5))
    return ncfg, packed


def _exact(x):
    hi, mid, lo = tfr.split3_ref(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    return torch.equal(total, x.double())


# f32 values whose two residuals stay in bf16's normal range (|x| above
# 2^-100: the lo term is about 2^-17 of x) and whose hi term does not
# round past bf16's largest value (|x| below 2^127); cotangents lie far
# inside both
_F32 = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 127 * 1.5,
                 allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=300, deadline=None)
@given(st.lists(_F32, min_size=1, max_size=64), st.booleans())
def test_split3_is_exact_across_the_exponent_range(vals, negative):
    x = torch.tensor(vals, dtype=torch.float32)
    assert _exact(-x if negative else x)


def test_split3_signed_zero_and_rounding_boundaries():
    z = torch.tensor([0.0, -0.0])
    hi, mid, lo = tfr.split3_ref(z)
    assert torch.equal(torch.signbit(hi), torch.tensor([False, True]))
    assert not (mid.float().any() or lo.float().any())
    # values at and next to the bf16 rounding boundaries: halfway between
    # two bf16 values (ties to even both ways), one f32 ulp either side,
    # and all-ones significands, at 1 and at 2^-90
    one = torch.tensor(1.0).view(torch.int32).item()
    bits = []
    for base in (one, one + (5 << 16), 0x3F7F0000, 0x12800000):
        for off in (0x7FFF, 0x8000, 0x8001, 0x17FFF, 0x18000, 0xFFFF):
            bits.append(base + off)
    x = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
    assert _exact(torch.cat([x, -x, x * 2.0 ** 60]))


@pytest.mark.parametrize('kind,N,K', [('dx', 256, 432), ('dx', 256, 256),
                                      ('dx', 128, 928), ('dw', 256, 432),
                                      ('dw', 256, 688), ('dw', 128, 928)])
def test_plain_split_product_matches_f64(kind, N, K):
    """The plain split product at K2's dX and dW shapes (layer 0, the
    trunk, the skip layer, the view layer) against an f64 matmul, beside
    an f32 matmul on the same inputs."""
    rng = np.random.default_rng(N + K)
    P = 700
    dy = torch.as_tensor(rng.normal(size=(P, N)) * 1e-3,
                         dtype=torch.float32)
    if kind == 'dx':
        b = torch.as_tensor(rng.normal(size=(N, K)) * 0.05,
                            dtype=torch.float32).to(torch.bfloat16).float()
        want = dy.double() @ b.double()
        f32 = dy @ b
    else:
        b = torch.as_tensor(np.maximum(rng.normal(size=(P, K)), 0.0),
                            dtype=torch.float32).to(torch.bfloat16).float()
        want = torch.cat([b.double().t() @ dy.double(),
                          dy.double().sum(0, keepdim=True)])
        f32 = torch.cat([b.t() @ dy, dy.sum(0, keepdim=True)])
    got = tfr.split_gemm_probe(kind, dy, b)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = ((got.double() - want).norm() / want.norm()).item()
    err32 = ((f32.double() - want).norm() / want.norm()).item()
    assert err < 2e-6 and err < 4 * err32 + 1e-9, (err, err32)


def test_fma_probe_plain_version_is_the_f32_product():
    rng = np.random.default_rng(1)
    dy = torch.as_tensor(rng.normal(size=(50, 64)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(64, 40)), dtype=torch.float32)
    assert torch.equal(tfr.fma_gemm_probe('dx', dy, w), dy @ w)
    x = torch.as_tensor(rng.normal(size=(50, 40)), dtype=torch.float32)
    got = tfr.fma_gemm_probe('dw', dy, x)
    assert got.shape == (41, 64)
    assert torch.equal(got[-1], dy.sum(0))


def test_t_image_round_trips_and_equals_fragment_weights(flagship):
    ncfg, packed = flagship
    img = packed['img_t']
    segs = tfr.t_image_segments(ncfg, 7, 4)
    assert img.numel() == sum(rp * n for _, _, _, rp, n in segs)
    assert all(rp % 256 == 0 for _, _, _, rp, _ in segs)
    got = tfr.weights_from_t_image(ncfg, packed, img)
    want = tfr._weights_f32(ncfg, packed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the padding rows of each segment hold zeros
    off = 0
    for _, _, rows, rpad, n in segs:
        seg = tfr.from_sm90_image(img[off:off + rpad * n], rpad, n)
        assert not seg[rows:].float().any()
        off += rpad * n


def test_t_image_slices_are_contiguous_256_row_tiles(flagship):
    """A 256-row tile of one k-slice of a segment, as the kernel's producer
    copies it, is the transposed weights' rows in the K-major swizzle."""
    ncfg, packed = flagship
    img = packed['img_t']
    ws = tfr._weights_f32(ncfg, packed)
    segs = tfr.t_image_segments(ncfg, 7, 4)
    i, r0, rows, rpad, n = segs[-1]                  # the view's xv rows
    off = sum(rp * nn for _, _, _, rp, nn in segs[:-1])
    wt = ws[i].t()[r0:r0 + rows]                     # (672, 128)
    for s in range(n // 64):
        for t in range(rpad // 256):
            start = off + s * rpad * 64 + t * 256 * 64
            tile = tfr.from_sm90_image(img[start:start + 256 * 64], 256, 64)
            want = torch.zeros(256, 64)
            part = wt[t * 256:(t + 1) * 256, s * 64:(s + 1) * 64]
            want[:part.shape[0]] = part
            assert torch.equal(tile.float(), want)


def test_t_image_holds_the_jax_weights():
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
    ws = tfr.weights_from_t_image(ncfg, packed, packed['img_t'])
    jp = jax.tree.map(np.asarray, params['coarse'])
    bf = lambda a: torch.as_tensor(np.array(a)).to(torch.bfloat16).float()
    dnet = ncfg.dnet_input
    assert torch.equal(ws[0][:, :dnet], bf(jp['pts_linears'][0]['w']).t())
    for i in range(1, ncfg.depth):
        w = bf(jp['pts_linears'][i]['w']).t()
        if (i - 1) in ncfg.skips:
            assert torch.equal(ws[i][:, packed['k0p']:], w[:, dnet:])
        else:
            assert torch.equal(ws[i], w)
    assert torch.equal(ws[ncfg.depth], bf(jp['feature_linear']['w']).t())
    vw = bf(jp['views_linears'][0]['w']).t()
    assert torch.equal(ws[-1][:, :vw.shape[1]], vw)


@pytest.mark.parametrize('P', [1, 64, 130, 2049])
def test_act_image_round_trips(P):
    F = 3584
    x = torch.randn(P, F).to(torch.bfloat16)
    img = tfr.act_image(x)
    assert img.numel() == -(-P // 64) * F * 64
    assert torch.equal(tfr.from_act_image(img, P, F), x)


def test_act_image_is_the_kernel_layout():
    """Point p's feature f sits where csrc/sm90_common.cuh's act_at puts
    it: tile p // 64, row f, 16-byte group ((p // 8) % 8) ^ (f % 8)."""
    P, F = 200, 72
    x = torch.arange(P * F, dtype=torch.int32).reshape(P, F)
    img = tfr.act_image(x)
    p, f = np.meshgrid(np.arange(P), np.arange(F), indexing='ij')
    at = (((p // 64) * F + f) * 64 + ((((p // 8) % 8) ^ (f % 8)) << 3)
          + p % 8)
    assert torch.equal(img[torch.as_tensor(at.reshape(-1))], x.reshape(-1))


def test_act_rows_of_the_flagship():
    rows = tfr.act_rows(_flagship_ncfg(), 7, 4)
    assert rows == {'x0': 0, 'xv': 448, 'h': 1152, 'feat': 3200,
                    'hv': 3456, 'F': 3584}


def test_k2_bound_is_the_split_bf16_bound():
    ms, by, what = roofline.flagship_bounds()['K2']
    assert by == 'operations' and 'train step' in what
    assert 3.55 < ms < 3.65
    # three bf16 passes of the cotangent products plus the bf16 recompute
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    P = 2048 * (64 + 80)
    want = (3 * 2 * roofline.bwd_f32_macs_per_point(ncfg)
            + 2 * roofline.mlp_macs_per_point(ncfg)) * P \
        / roofline.PEAK_BF16_FLOPS * 1e3
    assert ms == pytest.approx(want, rel=1e-9)
    assert roofline.k2_fp32_ms(ncfg, P) == pytest.approx(15.2314, abs=1e-3)
    assert roofline.flagship_bounds()['K2-d full'][0] == pytest.approx(ms)


@pytest.mark.parametrize('shapes,key', [((64, 80), 'K2 bf16'),
                                        ((8, 24), 'K2 bf16 culled'),
                                        ((8, 24), 'K2 culled')])
def test_k2_flavour_bounds(shapes, key):
    """K2's bf16 flavour: one bf16 pass of the cotangent products plus the
    recompute (1.547 ms a 2048-ray step at S = 64 + 80); both flavours at
    the culled S = 8 + 24."""
    ms, by, what = roofline.flagship_bounds()[key]
    assert by == 'operations' and 'train step' in what
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    P = 2048 * sum(shapes)
    passes = 3 if key == 'K2 culled' else 1
    want = (passes * 2 * roofline.bwd_f32_macs_per_point(ncfg)
            + 2 * roofline.mlp_macs_per_point(ncfg)) * P \
        / roofline.PEAK_BF16_FLOPS * 1e3
    assert ms == pytest.approx(want, rel=1e-9)
    if key == 'K2 bf16':
        assert 1.50 < ms < 1.60


def test_k2_design_bytes_with_bf16_cotangents():
    """Holding the MMA layers' cotangents as bf16 halves their bytes and
    leaves the f32 ones the PE backward reads (dx0, dxv) as they are."""
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    P = 2048 * 64
    f32 = roofline.k2_design_bytes(ncfg, 7, 4, P)
    assert f32 == roofline.k2_design_bytes(ncfg, 7, 4, P, cot_bytes=4)
    bf16 = roofline.k2_design_bytes(ncfg, 7, 4, P, cot_bytes=2)
    assert 0.7 * f32 < bf16 < 0.85 * f32
