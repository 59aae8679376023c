"""The CUDA kernels K1, K1-v1, K2 (both flavours), K2-v1, K3, K3-v1, K4,
K4-v1, K1-d and K2-d against their plain PyTorch versions, on the card (K1
and K2 also at the culled shapes S = 8 and 24; K1, K2 in both flavours, K3
and K4 also at the surreal_single network, multires_views 0, S = 96, 144
and 48), K2's split products alone against an f64 matmul, the kernel_bench
tool's bf16-flavour rows, and K1's kernel refusing a layout that does not
fit its shared memory at three stages, which the route plan runs at two.

Needs a CUDA device and nvcc; skips elsewhere. This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
Tolerances:
  * K1, K1-v1, K3, K3-v1, K4 and K4-v1, 2e-3 abs/rel (and K1-v1 against
    K1, K3 and K4 against K3-v1, K4-v1 and K1): the
    kernel and its plain version round the same activations to bf16 and
    differ by fp32 summation order and sin/cos ulps (observed 5e-4 abs
    for K1-v1 at the flagship width on an H100).
  * K1-d's early stages: 1e-2 of the digest's largest value. A digest
    sums about 280 bf16 MLP inputs (or 24 geometry values) a column;
    the kernel and the plain version round an occasional input to the
    next bf16 value (the __sincosf stage more often: the intrinsic is
    off by up to about 1e-4 at the PE's largest angles), each time by at
    most 2^-8 of the input. K1-d's full stage is K1: the same bits.
  * K2-d: its stages' outputs to K2's bounds (below); its full stage is
    K2: the same bits.
  * K2: dpts, dm_all and daux 2e-2 relative max (denominator floored
    at 1e-7), the JAX kernel-vs-oracle bound
    (tests/test_fused_render.py:119); each weight-gradient block 2e-2
    relative in the Frobenius norm and 0.12 relative max. K2's recompute
    and the plain version can round an activation to another bf16 value
    and so flip a ReLU mask, which moves single weight-gradient entries
    by one point's whole contribution (observed 2.4e-2 relative max on a
    block at R = 40, S = 64 on an H100); the f32 products differ only by
    summation order. Two launches on the same inputs agree bit for bit.
  * K1 and K2 at the culled shapes S = 8 and 24 (R = 256): K1 at 2e-3;
    K2 in both flavours to chip_smoke.py's bounds: every output 2e-2
    relative in the Frobenius norm and 0.12 relative max. With few
    samples a ray one flipped mask weighs more in a ray's dpts: observed
    2.5e-2 relative max on dpts at S = 24, tau = 35 on an H100.
  * K2's bf16 flavour (bwd_f32=False): those bounds against its plain
    version, and its MLP backward (K2-d's mlp stage) against the plain
    bf16 one on the kernel's own saved activations within 1.5e-3 relative
    in the Frobenius norm (chip_smoke.K2_BF16_FRO, where the readings
    are; observed 5.8e-4 at R = 256, S = 8), which the f32 flavour must
    exceed (observed 5.1e-3).
    K2-v1 to the same bounds, and K2 against K2-v1: their recomputes
    run different kernel bodies, which flip a mask as the plain version
    does.
  * K2's split products (`split_gemm_probe`) against f64: 1e-5 relative
    in the Frobenius norm. The three bf16 planes of the f32 cotangent sum
    to it exactly and each bf16 product is exact, so only the f32
    accumulation rounds (observed on the CPU plain version: 1e-7, the
    f32 FMA product's 3e-7); and no more than 4x K2-v1's FMA GEMM's error
    on the same inputs.
  * The layered route (a 3 x 512 trunk): K1 and K3 at 2e-3 as above;
    K2's saved activations at 2e-2 as below.
  * K2's saved activations against the plain `_forward_trace`: 2e-2
    abs/rel. Both round the same f32 sums to bf16, in another summation
    order, which moves an occasional activation by one bf16 step (2^-8
    relative) and the layers after it by less.
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


def _rays(dev, R, S, seed):
    """Random points (R, S, 3), ray directions, skeletons and
    framecodes."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pts = f(rng.normal(size=(R, S, 3)) * 0.4)
    skts = torch.zeros((R, 24, 4, 4), device=dev)
    skts[..., :3, :3] = axisang_to_rot(f(rng.normal(size=(R, 24, 3))))
    skts[..., :3, 3] = f(rng.normal(size=(R, 24, 3)) * 0.3)
    skts[..., 3, 3] = 1.0
    return pts, f(rng.normal(size=(R, 1, 3))), skts, \
        f(rng.normal(size=(R, 16)))


def _operands(dev, R, S, seed):
    pts, rays_d, skts, fc = _rays(dev, R, S, seed)
    return (pts, *fr.pack_ray_data(rays_d, skts, fc))


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(1, 64, 35.0), (3, 7, 2000.0),
                                     (512, 80, 2000.0), (512, 8, 2000.0),
                                     (512, 24, 35.0)])
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


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (512, 80, 2000.0)])
def test_k1_v1_kernel_matches_plain_and_k1(cuda, R, S, tau):
    """K1-v1, kept as K1's comparison: against the plain version and
    against K1 on the same operands, both at K1's tolerance."""
    ncfg = _flagship_ncfg()
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), cuda)
    packed = fr.pack_render_params(params, ncfg, 7, 4,
                                   torch.full((24,), 0.5, device=cuda))
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    before = (fr.LAUNCHES, fr.V1_LAUNCHES)
    got = fr.fused_encode_mlp_pts_v1(ncfg, packed, pts, m_all, aux, S, tau)
    k1 = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    torch.cuda.synchronize()
    assert (fr.LAUNCHES, fr.V1_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S, tau)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(got, k1, atol=2e-3, rtol=2e-3)


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


def _k2_bounds(ncfg, got, want, nfk=7, nfv=4):
    """chip_smoke.py's K2 bounds on every output: 2e-2 relative
    Frobenius, 0.12 relative max."""
    pairs = list(zip(fr.split_grads(ncfg, nfk, nfv, got[0]).values(),
                     fr.split_grads(ncfg, nfk, nfv, want[0]).values()))
    for a, b in pairs + list(zip(got[1:], want[1:])):
        assert _rel_fro(a, b) < 2e-2 and _rel(a, b) < 0.12


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(256, 8, 2000.0), (256, 24, 35.0)])
def test_k1_k2_at_cull_shapes_match_plain(cuda, R, S, tau):
    ncfg, _, packed = _packed(cuda, seed=1)
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    k1 = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    got = fr.fused_bwd(ncfg, packed, pts, m_all, aux, S, tau, g)
    again = fr.fused_bwd(ncfg, packed, pts, m_all, aux, S, tau, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k1, fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau), atol=2e-3, rtol=2e-3)
    _k2_bounds(ncfg, got, fr.fused_bwd_ref(ncfg, packed, pts, m_all, aux,
                                           S, tau, g))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (40, 64, 2000.0),
                                     (256, 8, 2000.0), (256, 24, 35.0)])
def test_k2_bf16_matches_plain_and_is_deterministic(cuda, R, S, tau):
    ncfg, _, packed = _packed(cuda, seed=1)
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    args = (ncfg, packed, pts, m_all, aux, S, tau, g)
    before = (fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    got = fr.fused_bwd(*args, bwd_f32=False)
    again = fr.fused_bwd(*args, bwd_f32=False)
    torch.cuda.synchronize()
    assert (fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES) == (before[0],
                                                        before[1] + 2)
    _k2_bounds(ncfg, got, fr.fused_bwd_ref(*args, bwd_f32=False))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # the MLP backward on the kernel's own activations, both flavours
    P = R * S
    fro = []
    for f32 in (False, True):
        t = fr.launch_bwd(2, *args, bwd_f32=f32)
        want = fr.mlp_bwd_ref(*args, bwd_f32=False, trace=fr.trace_from_act(
            ncfg, packed, t['act'], P))
        pairs = list(zip(fr.split_grads(ncfg, 7, 4, t['dW']).values(),
                         fr.split_grads(ncfg, 7, 4, want[0]).values()))
        pairs += [(t['dx0'], want[1].reshape(P, -1)),
                  (t['dxv'], want[2].reshape(P, -1))]
        fro.append(max(_rel_fro(a, b) for a, b in pairs))
    assert fro[0] < 1.5e-3 < fro[1], fro


@pytest.mark.gpu
@pytest.mark.parametrize('flags', [('--bwd_bf16',),
                                   ('--decompose_bwd', '--bwd_bf16')])
def test_kernel_bench_bwd_bf16_rows(cuda, capsys, flags):
    import json
    from anerf_torch.tools import kernel_bench as kb
    assert kb.main(['--rays', '64', '--reps', '2', '--shapes', '8', '24',
                    *flags]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['device'] == torch.cuda.get_device_name(0)
    if len(flags) == 1:
        rows = [r for r in rec['rows'] if r['kind'] == 'bwd_bf16']
        assert [r['S'] for r in rows] == [8, 24]
        assert all(r['ms'] > 0 for r in rows)
    else:
        assert [r['S'] for r in rec['rows']] == [8, 24]
        assert all(r['bwd_f32'] is False and r['full_ms'] > 0
                   for r in rec['rows'])


def _flagship_ncfg():
    return NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)


def _packed(dev, seed=0):
    ncfg = _flagship_ncfg()
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(seed), dev)
    params['alpha_linear']['b'] += 1.0
    return ncfg, params, fr.pack_render_params(
        params, ncfg, 7, 4, torch.full((24,), 0.5, device=dev))


def _raw_inputs(dev, R, S, seed):
    """K3's rows (build_raw_inputs) of `_rays`."""
    return fr.build_raw_inputs(*_rays(dev, R, S, seed))


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (256, 80, 2000.0)])
def test_k3_kernel_matches_plain(cuda, R, S, tau):
    """K3 (K1's kernel, IN_RAW) against its plain version and, at the same
    tolerance, K3-v1; K3-v1's count stays."""
    ncfg, _, packed = _packed(cuda)
    x = _raw_inputs(cuda, R, S, R + S)
    before = (fr.RAW_LAUNCHES, fr.RAW_V1_LAUNCHES)
    got = fr.fused_encode_mlp(ncfg, packed, x, tau)
    torch.cuda.synchronize()
    assert (fr.RAW_LAUNCHES, fr.RAW_V1_LAUNCHES) == (before[0] + 1,
                                                      before[1])
    assert got.shape == (R, S, 4)
    want = fr.fused_encode_mlp_ref(ncfg, packed, x, tau)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(got, fr.fused_encode_mlp_v1(ncfg, packed, x,
                                                           tau),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (256, 80, 2000.0)])
def test_k3_v1_kernel_matches_plain(cuda, R, S, tau):
    """K3-v1, kept as K3's comparison: the checks K3 had on K1-v1's
    body."""
    ncfg, _, packed = _packed(cuda)
    x = _raw_inputs(cuda, R, S, R + S)
    before = fr.RAW_V1_LAUNCHES
    got = fr.fused_encode_mlp_v1(ncfg, packed, x, tau)
    torch.cuda.synchronize()
    assert fr.RAW_V1_LAUNCHES == before + 1 and got.shape == (R, S, 4)
    want = fr.fused_encode_mlp_ref(ncfg, packed, x, tau)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


def _k4_setup(dev, config):
    from anerf_torch.kernels import fused_mlp as fm
    ncfg = {'flagship': _flagship_ncfg(),
            'small': NeRFConfig(depth=4, width=256, input_ch=24,
                                input_ch_bones=0, input_ch_views=72,
                                skips=(2,), use_viewdirs=True),
            # widths the kernel's 16-byte copy needs padded to 8
            'odd_widths': NeRFConfig(depth=3, width=256, input_ch=30,
                                     input_ch_bones=0, input_ch_views=70,
                                     skips=(), use_viewdirs=True)}[config]
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(2), dev)
    packed = fm.pack_params(params, ncfg)
    rng = np.random.default_rng(4)
    P = 1500
    x_pts = torch.as_tensor(rng.normal(size=(P, ncfg.dnet_input)),
                            dtype=torch.float32, device=dev)
    x_view = torch.as_tensor(rng.normal(size=(P, fm.view_in(ncfg))),
                             dtype=torch.float32, device=dev)
    return fm, ncfg, packed, x_pts, x_view


@pytest.mark.gpu
@pytest.mark.parametrize('config', ['flagship', 'small', 'odd_widths'])
def test_k4_kernel_matches_plain(cuda, config):
    """K4 (K1's kernel, IN_EMBEDDED, on K4's weight image) against its
    plain version and, at the same tolerance, K4-v1; K4-v1's count
    stays."""
    fm, ncfg, packed, x_pts, x_view = _k4_setup(cuda, config)
    before = (fm.LAUNCHES, fm.V1_LAUNCHES)
    got = fm.fused_mlp_apply(ncfg, packed, x_pts, x_view)
    torch.cuda.synchronize()
    assert (fm.LAUNCHES, fm.V1_LAUNCHES) == (before[0] + 1, before[1])
    want = fm.fused_mlp_apply_ref(ncfg, packed, x_pts, x_view)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(
        got, fm.fused_mlp_apply_v1(ncfg, packed, x_pts, x_view), atol=2e-3,
        rtol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize('config', ['flagship', 'small', 'odd_widths'])
def test_k4_v1_kernel_matches_plain(cuda, config):
    """K4-v1, kept as K4's comparison: the checks K4 had on K1-v1's
    body."""
    fm, ncfg, packed, x_pts, x_view = _k4_setup(cuda, config)
    before = fm.V1_LAUNCHES
    got = fm.fused_mlp_apply_v1(ncfg, packed, x_pts, x_view)
    torch.cuda.synchronize()
    assert fm.V1_LAUNCHES == before + 1
    want = fm.fused_mlp_apply_ref(ncfg, packed, x_pts, x_view)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
def test_layout_over_the_limit_raises_on_the_card(cuda):
    """K4 of x0 480 columns wide: the single kernel fits at two weight
    stages only (`route_plan`), where K4's wrapper takes the layered
    route (the faster there; here on one tile of points, a cluster of
    one CTA) and agrees with the plain version, and the single kernel's
    launcher itself refuses the layout at three stages
    (cudaErrorInvalidValue), launching nothing."""
    import ctypes
    from anerf_torch.kernels import fused_mlp as fm
    ncfg = NeRFConfig(depth=4, width=256, input_ch=480, input_ch_bones=0,
                      input_ch_views=72, skips=(2,), use_viewdirs=True)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(2), cuda)
    packed = fm.pack_params(params, ncfg)
    route = fr.route_plan(ncfg, 480, 72)
    assert (route.kind, route.stages) == ('single', 2)
    assert fr.route_plan(ncfg, 480, 72, embedded=True).kind == 'layered'
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn((100, 480), device=cuda, generator=g)
    xv = torch.randn((100, 72), device=cuda, generator=g)
    before, layered = fm.LAUNCHES, fr.LAYERED_LAUNCHES['k4']
    got = fm.fused_mlp_apply(ncfg, packed, x0, xv)
    torch.cuda.synchronize()
    want = fm.fused_mlp_apply_ref(ncfg, packed, x0, xv)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert fm.LAUNCHES == before + 1
    assert fr.LAYERED_LAUNCHES['k4'] == layered + 1
    x0, xv = x0.to(torch.bfloat16), xv.to(torch.bfloat16)
    out = torch.empty((100, 4), device=cuda)
    lib = fr._library('fused_render_sm90')
    err = lib.anerf_fused_mlp_sm90(
        fr.SM90_STAGES, x0.data_ptr(), xv.data_ptr(),
        packed['img'].data_ptr(), packed['b'].data_ptr(),
        packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
        packed['b_out'].data_ptr(), out.data_ptr(), 100, ncfg.depth,
        packed['skip'].data_ptr(), 480, 72,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    assert b'invalid' in lib.anerf_cuda_error_string(err)
    assert isinstance(lib, ctypes.CDLL)


def _single(dev):
    """configs/surreal/surreal_single.txt's network (anerf_torch/tools/
    flagship.py: SURREAL_SINGLE): nfk 7, nfv 0, K1's operands and K4's."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.tools.flagship import SURREAL_SINGLE, flagship
    _, cfg, params, *_ = flagship(8, device=dev, **SURREAL_SINGLE)
    nfk, nfv = cfg.embed_kp.num_freqs, cfg.embed_view.num_freqs
    assert (nfk, nfv) == (7, 0) and cfg.single_net
    packed = fr.pack_render_params(params['coarse'], cfg.nerf, nfk, nfv,
                                   params['cutoff_dist'])
    return cfg.nerf, packed, fm.pack_params(params['coarse'], cfg.nerf)


@pytest.mark.gpu
@pytest.mark.parametrize('S,tau', [(96, 2000.0), (144, 35.0), (48, 2000.0)])
def test_surreal_single_forward_kernels_match_plain(cuda, S, tau):
    """K1, K3 and K4 at the surreal_single network (XV 88 columns, padded
    to 128 in the kernel) against their plain versions, and K3, K4
    against K1 and their first versions on the same points; S = 96 and
    48 are its coarse and fine passes (single_net renders the 48 new
    samples alone), 144 both."""
    from anerf_torch.kernels import fused_mlp as fm
    ncfg, packed, packed4 = _single(cuda)
    R = 64
    pts, rays_d, skts, fc = _rays(cuda, R, S, S)
    m_all, aux = fr.pack_ray_data(rays_d, skts, fc)
    k1 = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    x = fr.build_raw_inputs(pts, rays_d, skts, fc)
    k3 = fr.fused_encode_mlp(ncfg, packed, x, tau)
    x0, xv = fr._encode(packed, pts, m_all, aux, S, tau)
    k0, kv = ncfg.dnet_input, fm.view_in(ncfg)
    assert (k0, kv) == (432, 88)
    bf = torch.bfloat16
    x0, xv = (x0[..., :k0].reshape(-1, k0).to(bf),
              xv[..., :kv].reshape(-1, kv).to(bf))
    k4 = fm.fused_mlp_apply(ncfg, packed4, x0, xv).reshape(R, S, 4)
    torch.cuda.synchronize()
    like = dict(atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(k1, fr.fused_encode_mlp_pts_ref(
        ncfg, packed, pts, m_all, aux, S, tau), **like)
    torch.testing.assert_close(k3, fr.fused_encode_mlp_ref(ncfg, packed, x,
                                                           tau), **like)
    torch.testing.assert_close(k4, fm.fused_mlp_apply_ref(
        ncfg, packed4, x0, xv).reshape(R, S, 4), **like)
    torch.testing.assert_close(k3, k1, **like)
    torch.testing.assert_close(k4, k1, **like)
    # and the first versions on the same inputs
    torch.testing.assert_close(k3, fr.fused_encode_mlp_v1(ncfg, packed, x,
                                                          tau), **like)
    torch.testing.assert_close(k4, fm.fused_mlp_apply_v1(
        ncfg, packed4, x0, xv).reshape(R, S, 4), **like)


@pytest.mark.gpu
@pytest.mark.parametrize('S,bwd_f32', [(96, True), (144, True), (96, False),
                                       (144, False), (48, True)])
def test_surreal_single_k2_matches_plain(cuda, S, bwd_f32):
    """K2 in both flavours at the surreal_single network against its plain
    version of the same flavour, at chip_smoke.py's K2 bounds; two
    launches bit-equal."""
    ncfg, packed, _ = _single(cuda)
    R = 64
    pts, m_all, aux = _operands(cuda, R, S, S + 1)
    g = torch.as_tensor(np.random.default_rng(S).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    args = (ncfg, packed, pts, m_all, aux, S, 2000.0, g)
    got = fr.fused_bwd(*args, bwd_f32=bwd_f32)
    again = fr.fused_bwd(*args, bwd_f32=bwd_f32)
    torch.cuda.synchronize()
    _k2_bounds(ncfg, got, fr.fused_bwd_ref(*args, bwd_f32=bwd_f32), 7, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize('stage', ['transform', 'pe', 'pe_notrig',
                                   'pe_fasttrig', 'full'])
def test_k1d_stage_matches_plain(cuda, stage):
    from anerf_torch.kernels import stages
    ncfg, _, packed = _packed(cuda)
    R, S = 40, 64
    pts, m_all, aux = _operands(cuda, R, S, 11)
    args = (ncfg, packed, pts, m_all, aux, S, 2000.0)
    before = stages.FWD_LAUNCHES
    got = stages.decompose_fwd(stage, *args)
    torch.cuda.synchronize()
    assert stages.FWD_LAUNCHES == before + 1
    if stage == 'full':
        assert torch.equal(got, fr.fused_encode_mlp_pts(*args))
    else:
        assert _rel(got, stages.decompose_fwd_ref(stage, *args)) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize('stage', ['recompute', 'mlp', 'pe', 'full'])
def test_k2d_stage_matches_plain(cuda, stage):
    from anerf_torch.kernels import stages
    ncfg, _, packed = _packed(cuda, seed=1)
    R, S = 40, 64
    pts, m_all, aux = _operands(cuda, R, S, 12)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    args = (ncfg, packed, pts, m_all, aux, S, 2000.0, g)
    before = stages.BWD_LAUNCHES
    got = stages.decompose_bwd(stage, *args)
    torch.cuda.synchronize()
    assert stages.BWD_LAUNCHES == before + 1
    want = stages.decompose_bwd_ref(stage, *args)
    if stage == 'full':
        assert all(torch.equal(a, b)
                   for a, b in zip(got, fr.fused_bwd(*args)))
    if stage == 'recompute':
        torch.testing.assert_close(got[0], want[0], atol=2e-3, rtol=2e-3)
        return
    blocks = fr.split_grads(ncfg, 7, 4, got[0])
    for name, ref in fr.split_grads(ncfg, 7, 4, want[0]).items():
        assert _rel_fro(blocks[name], ref) < 2e-2, name
        assert _rel(blocks[name], ref) < 0.12, name
    for a, b in zip(got[1:], want[1:]):
        assert _rel_fro(a, b) < 2e-2 and _rel(a, b) < 0.12


@pytest.mark.gpu
@pytest.mark.parametrize('kind,N,K', [('dx', 256, 432), ('dx', 256, 256),
                                      ('dx', 128, 256), ('dx', 128, 672),
                                      ('dw', 256, 432), ('dw', 256, 256),
                                      ('dw', 128, 256), ('dw', 128, 672)])
def test_split_gemm_probe_matches_f64(cuda, kind, N, K):
    """Every shape of K2's products: dX = dY W (W (N, K) bf16 weights)
    and dW = X^T dY with its bias row (X (P, K) bf16 activations), over
    P = 3000 points (two chunks, a ragged last tile)."""
    rng = np.random.default_rng(N + K)
    P = 3000
    dy = torch.as_tensor(rng.normal(size=(P, N)) * 1e-3,
                         dtype=torch.float32, device=cuda)
    if kind == 'dx':
        b = torch.as_tensor(rng.normal(size=(N, K)) * 0.05,
                            dtype=torch.float32, device=cuda)
        want = dy.double() @ b.to(torch.bfloat16).double()
    else:
        b = torch.as_tensor(np.maximum(rng.normal(size=(P, K)), 0.0),
                            dtype=torch.float32, device=cuda)
        bd = b.to(torch.bfloat16).double()
        want = torch.cat([bd.t() @ dy.double(),
                          dy.double().sum(0, keepdim=True)])
    b = b.to(torch.bfloat16)
    got = fr.split_gemm_probe(kind, dy, b)
    fma = fr.fma_gemm_probe(kind, dy, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = ((got.double() - want).norm() / want.norm()).item()
    err_fma = ((fma.double() - want).norm() / want.norm()).item()
    assert err < 1e-5 and err <= 4 * err_fma, (err, err_fma)


@pytest.mark.gpu
@pytest.mark.parametrize('R,S', [(3, 7), (40, 64)])
def test_k2_saved_activations_match_plain_trace(cuda, R, S):
    """K2's recompute (K1 with SAVE): raw bit-equal to K1, and the saved
    activations, with the tile layout undone, against the plain trace."""
    ncfg, _, packed = _packed(cuda, seed=1)
    pts, m_all, aux = _operands(cuda, R, S, 13)
    g = torch.zeros((R, S, 4), device=cuda)
    t = fr.launch_bwd(1, ncfg, packed, pts, m_all, aux, S, 2000.0, g)
    k1 = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, 2000.0)
    torch.cuda.synchronize()
    assert torch.equal(t['raw'].view(R, S, 4), k1)
    rows = fr.act_rows(ncfg, 7, 4)
    act = fr.from_act_image(t['act'], R * S, rows['F']).float()
    tr = fr._forward_trace(ncfg, packed, pts, m_all, aux, S, 2000.0)
    flat = lambda x: x.reshape(R * S, -1)
    W = ncfg.width
    pieces = [('x0', flat(tr['x0'])), ('xv', flat(tr['xv'])),
              ('feat', flat(tr['feat'])), ('hv', flat(tr['hv']))]
    pieces += [(rows['h'] + i * W, flat(h)) for i, h in enumerate(tr['hs'])]
    for at, want in pieces:
        r0 = rows[at] if isinstance(at, str) else at
        torch.testing.assert_close(act[:, r0:r0 + want.shape[1]], want,
                                   atol=2e-2, rtol=2e-2)
    # the padding rows of x0 and xv hold zeros
    assert not act[:, 432:rows['xv']].any()
    assert not act[:, rows['xv'] + 664:rows['h']].any()


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (40, 64, 2000.0)])
def test_k2_v1_matches_plain_and_k2(cuda, R, S, tau):
    ncfg, _, packed = _packed(cuda, seed=1)
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    before = (fr.BWD_LAUNCHES, fr.BWD_V1_LAUNCHES)
    v1 = fr.fused_bwd_v1(ncfg, packed, pts, m_all, aux, S, tau, g)
    k2 = fr.fused_bwd(ncfg, packed, pts, m_all, aux, S, tau, g)
    torch.cuda.synchronize()
    assert (fr.BWD_LAUNCHES, fr.BWD_V1_LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)
    want = fr.fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g)
    for got in (v1, want):
        blocks = fr.split_grads(ncfg, 7, 4, got[0])
        for name, ref in fr.split_grads(ncfg, 7, 4, k2[0]).items():
            assert _rel_fro(blocks[name], ref) < 2e-2, name
            assert _rel(blocks[name], ref) < 0.12, name
        for a, b in zip(got[1:], k2[1:]):
            assert _rel(a, b) < 2e-2


def _layered_packed(dev):
    """A 3 x 512 trunk with a skip into layer 2, multires 7 / 4, 16-wide
    framecodes: the layered route (`route_plan`)."""
    ncfg = NeRFConfig(depth=3, width=512, skips=(1,), use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(5), dev)
    params['alpha_linear']['b'] += 1.0
    packed = fr.pack_render_params(params, ncfg, 7, 4,
                                   torch.full((24,), 0.5, device=dev))
    assert fr.route_plan(ncfg, packed['k0'], packed['kv']).kind == 'layered'
    return ncfg, packed


@pytest.mark.gpu
@pytest.mark.parametrize('R,S', [(3, 7), (67, 80)])
def test_k2_bf16_wide_trunk_matches_plain(cuda, R, S):
    """K2's bf16 flavour on a 3 x 512 trunk (the layered route's
    recompute; 512 outputs, so a DX CTA walks W^T's eight k-slices
    through the ring, two 256-column tiles a layer): every output within
    K2's bounds of the plain version, the MLP stage's bias rows (the DX
    epilogues' and the heads' partials) within 1.5e-3 of the plain
    backward's on the kernel's own activations, two launches bit-equal,
    the scratch as bwd_plan sizes it."""
    ncfg, packed = _layered_packed(cuda)
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    g = torch.as_tensor(np.random.default_rng(7).normal(size=(R, S, 4)),
                        dtype=torch.float32, device=cuda)
    args = (ncfg, packed, pts, m_all, aux, S, 2000.0, g)
    got = fr.fused_bwd(*args, bwd_f32=False)
    again = fr.fused_bwd(*args, bwd_f32=False)
    torch.cuda.synchronize()
    _k2_bounds(ncfg, got, fr.fused_bwd_ref(*args, bwd_f32=False))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    P = R * S
    t = fr.launch_bwd(2, *args, bwd_f32=False)
    plan = fr.bwd_plan(ncfg, packed, P, False)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in t.items()
            if k in plan['scratch']} == plan['scratch']
    want = fr.mlp_bwd_ref(*args, bwd_f32=False, trace=fr.trace_from_act(
        ncfg, packed, t['act'], P))
    for (at, n, _) in fr.bias_map(ncfg, 7, 4):
        assert _rel_fro(t['dW'][at:at + n], want[0][at:at + n]) < 1.5e-3


@pytest.mark.gpu
@pytest.mark.parametrize('R,S,tau', [(3, 7, 35.0), (131, 1, 2000.0),
                                     (67, 80, 2000.0)])
def test_layered_route_matches_plain(cuda, R, S, tau):
    """The layered route: K1 and K3 against their plain versions,
    relaunches bit-equal; K2's recompute (its activations in the act
    layout, where its layers read them) with raw bit-equal to K1's (the
    same sums of the same bf16 operands), its saved activations against
    the plain trace, the padding rows of x0 and xv and every row of the
    points past P zero. S = 1 puts 64 rays in a tile (phase A's per-ray
    view-band table at its largest); 21, 131 and 5,360 points make odd
    counts of tiles, the last one partial."""
    ncfg, packed = _layered_packed(cuda)
    pts, m_all, aux = _operands(cuda, R, S, R + S)
    before = dict(fr.LAYERED_LAUNCHES)
    k1 = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    again = fr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
    x = _raw_inputs(cuda, R, S, R + S)
    k3 = fr.fused_encode_mlp(ncfg, packed, x, tau)
    g = torch.zeros((R, S, 4), device=cuda)
    t = fr.launch_bwd(1, ncfg, packed, pts, m_all, aux, S, tau, g)
    torch.cuda.synchronize()
    assert fr.LAYERED_LAUNCHES['k1'] == before['k1'] + 2
    assert fr.LAYERED_LAUNCHES['k3'] == before['k3'] + 1
    assert fr.LAYERED_LAUNCHES['k2'] == before['k2'] + 1
    assert torch.equal(k1, again)
    torch.testing.assert_close(
        k1, fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau), atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(k3, fr.fused_encode_mlp_ref(ncfg, packed, x,
                                                           tau),
                               atol=2e-3, rtol=2e-3)
    assert torch.equal(t['raw'].view(R, S, 4), k1)
    P, rows = R * S, fr.act_rows(ncfg, 7, 4)
    padded = -(-P // 64) * 64
    act = fr.from_act_image(t['act'], padded, rows['F']).float()
    assert not act[P:].any()
    act = act[:P]
    tr = fr._forward_trace(ncfg, packed, pts, m_all, aux, S, tau)
    flat = lambda y: y.reshape(P, -1)
    W = ncfg.width
    pieces = [('x0', flat(tr['x0'])), ('xv', flat(tr['xv'])),
              ('feat', flat(tr['feat'])), ('hv', flat(tr['hv']))]
    pieces += [(rows['h'] + i * W, flat(h)) for i, h in enumerate(tr['hs'])]
    for at, want in pieces:
        r0 = rows[at] if isinstance(at, str) else at
        torch.testing.assert_close(act[:, r0:r0 + want.shape[1]], want,
                                   atol=2e-2, rtol=2e-2)
    assert not act[:, 432:rows['xv']].any()
    assert not act[:, rows['xv'] + 664:rows['h']].any()
