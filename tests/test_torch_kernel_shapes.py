"""The fused branch of anerf_torch at every shape the JAX gate admits
beyond the flagship's, against anerf_tpu, on the CPU.

The port's gates (`fused_render_supported`, `fused_mlp.supports_config`)
are JAX's, condition for condition; `render.factory.build_render_config`
takes every config they admit; the route plan keeps the flagship on the
single kernel at three weight stages and says where the others go. On
CPU tensors the wrappers run the kernels' plain versions, so the plain
K1, K3, K4 and K2 (both flavours) are held here against the JAX Pallas
kernels, in interpret mode as the JAX package's own tests run them, at
these shapes (the CUDA routes are held to the plain versions on the card
by chip_smoke.py --shapes):
  wide-net    width 512, depth 8 (4 for the train step), multires 7 / 4,
              framecodes of 16;
  wide-input  width 256, depth 8, multires 10 / 6, framecodes of 32;
  depth 5     width 256, whose skip after layer 4 feeds no layer;
  depth 40    width 256, past the first versions' 31 trunk layers.

Tolerances, the bounds of the flagship's parity tests:
  * plain K1, K3, K4 vs the Pallas kernel: 3e-2 abs/rel (CROSS). Both
    keep each product in f32 and round the same activations to bf16; the
    JAX kernel's geometry is hi/lo bf16 splits and its sin/cos a 3e-6
    polynomial, which flip an occasional bf16 rounding, and a wider or
    deeper trunk carries a flip further.
  * plain K2 vs the JAX fused_apply VJP: 2e-2 relative in the Frobenius
    norm for every parameter leaf, the points, skts and the framecodes
    (tests/test_torch_fused_bwd.py's bound). The port's backward reads
    the JAX kernel's own recompute (`jfr._forward_trace` on the same
    tile, converted to the port's layout), so the comparison sees the
    two backwards' arithmetic: with each side's own recompute about one
    ReLU mask a layer flips among these 32 points (summation order), and
    at the wide shapes that alone moved the first layers' gradients by
    4-6% in the Frobenius norm (8 x 512: layers 0-5, which a flip at the
    skip layer reaches), however the 32 points were drawn.
  * one train step on the fused branch vs JAX's `make_train_step(raw=
    True)`: tests/test_torch_train.py's bounds (losses 1e-4 relative, the
    first Adam moments 2e-2 relative max).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from anerf_tpu.kernels import fused_mlp as jfm
from anerf_tpu.kernels import fused_render as jfr
from anerf_tpu.models.nerf import NeRFConfig as JaxNeRFConfig
from anerf_tpu.models.nerf import lookup_framecodes
from anerf_tpu.pose import pose_opt as jpose
from anerf_tpu.render.factory import build_render_config as j_build
from anerf_tpu.render.raycaster import encode_inputs, run_network
from anerf_tpu.train import state as jst
from anerf_tpu.train.trainer import make_train_step as j_make_train_step

from anerf_torch.config import TrainConfig as TorchTrainConfig
from anerf_torch.convert import params_from_numpy, train_state_from_numpy
from anerf_torch.kernels import fused_mlp as tfm
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.models.nerf import NeRFConfig
from anerf_torch.pose import pose_opt as tpose
from anerf_torch.render.factory import build_render_config as t_build
from anerf_torch.render.factory import init_render_params as t_init
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.train import state as tst
from anerf_torch.train.trainer import make_train_step

from helpers import synthetic_batch, tiny_args

CROSS = dict(atol=3e-2, rtol=3e-2)
K2_FRO = 2e-2
R, S = 8, 4

#: the slice's shapes (TrainConfig overrides of tests/helpers.py's tiny
#: args, bf16 compute)
SHAPES = {
    'wide-net': dict(netwidth=512, netdepth=4, multires=7,
                     multires_views=4),
    'wide-net-8': dict(netwidth=512, netdepth=8, multires=7,
                       multires_views=4),
    'wide-input': dict(netwidth=256, netdepth=8, multires=10,
                       multires_views=6, framecode_size=32),
    'depth-5': dict(netwidth=256, netdepth=5, multires=7, multires_views=4),
    'depth-40': dict(netwidth=256, netdepth=40, multires=7,
                     multires_views=4),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _relfro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-7)


def _data_attrs(n_views=8):
    return {'skel_type': SMPLSkeleton, 'n_views': n_views}


def _pose_data(rng, n_frames=8, scale=0.0025):
    """tests/helpers.py's synthetic_pose_data through the port's FK (the
    same function; JAX's compiles anew in every process)."""
    from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
    from anerf_torch.ops.fk import fk
    from anerf_torch.skeleton import smpl_rest_pose
    rest = (smpl_rest_pose * scale).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.1).astype(np.float32)
    kp3d, skts, _, _ = fk(torch.as_tensor(bones), torch.as_tensor(rest),
                          torch.as_tensor(pelvis))
    cyls = get_kp_bounding_cylinder(kp3d.numpy(), ext_scale=0.001,
                                    head='-y')
    return {'rest_pose': rest, 'bones': bones, 'pelvis': pelvis,
            'kp3d': kp3d.numpy(), 'skts': skts.numpy(),
            'cyls': cyls.astype(np.float32)}


# ------------------------------------------------------------ the gates

def _gate_args(width, depth, fc, multires, views, **kw):
    return tiny_args(netwidth=width, netdepth=depth, multires=multires,
                     multires_views=views, opt_framecode=fc is not None,
                     framecode_size=fc or 16, compute_dtype='bfloat16',
                     **kw)


GRID = list(itertools.product((256, 384, 512, 768), (2, 4, 5, 8, 40),
                              (8, 16, 32, None), (7, 8, 9, 10), (4, 5, 6)))


def test_fused_render_supported_is_the_jax_gate():
    """Over width 256 / 384 / 512 / 768, depth 2-40, framecodes 8 / 16 / 32
    and none, multires 7-10 and views 4-6: the port's gate equals JAX's
    (384 is out: half of it is not a multiple of 128); the existing
    negative cases stay out in both."""
    seen = set()
    for width, depth, fc, mr, mv in GRID:
        args = _gate_args(width, depth, fc, mr, mv)
        jcfg = j_build(args, _data_attrs())
        tcfg = t_build(TorchTrainConfig(**dataclasses.asdict(args)),
                       _data_attrs())
        want = jfr.fused_render_supported(jcfg)
        assert tfr.fused_render_supported(tcfg) == want, (width, depth, fc)
        seen.add(want)
    assert seen == {True, False}
    for kw in (dict(kp_dist_type='relpos'), dict(bone_type='axisang'),
               dict(view_type='world'), dict(use_viewdirs=False),
               dict(cutoff_inputs=False), dict(multires_bones=2)):
        args = _gate_args(256, 8, 16, 7, 4, **kw)
        jcfg = j_build(args, _data_attrs())
        tcfg = t_build(TorchTrainConfig(**dataclasses.asdict(args)),
                       _data_attrs())
        assert not jfr.fused_render_supported(jcfg), kw
        assert not tfr.fused_render_supported(tcfg), kw


def test_k4_supports_config_is_the_jax_gate():
    for width, depth, views, fc in itertools.product(
            (128, 256, 384, 512, 768), (1, 2, 4, 5, 8, 40), (True, False),
            (True, False)):
        kw = dict(depth=depth, width=width, input_ch=24 * 21,
                  input_ch_bones=72, input_ch_views=72 * 13,
                  use_viewdirs=views, use_framecode=fc, framecode_ch=32,
                  n_framecodes=4)
        assert tfm.supports_config(NeRFConfig(**kw)) == \
            jfm.supports_config(JaxNeRFConfig(**kw)), kw


def test_build_render_config_takes_every_admitted_config():
    """--fused_kernel with every grid config the gate admits builds (the
    factory's refusal is JAX's, nothing more), and the route plan never
    refuses one: the flagship's single kernel at three stages, two where
    only two fit, the layered route for the rest."""
    routes = set()
    for width, depth, fc, mr, mv in GRID:
        args = TorchTrainConfig(**dataclasses.asdict(
            _gate_args(width, depth, fc, mr, mv, fused_kernel=True)))
        if width == 384:
            with pytest.raises(NotImplementedError):
                t_build(args, _data_attrs())
            continue
        cfg = t_build(args, _data_attrs())
        assert cfg.use_fused
        k0, _, kv, _ = tfr.input_widths(mr, mv, tfr.fc_width(cfg.nerf))
        route = tfr.route_plan(cfg.nerf, k0, kv)
        routes.add((route.kind, route.stages))
        assert route.kind == 'layered' or route.smem <= tfr.SM90_MAX_SMEM
        assert tfr.route_plan(cfg.nerf, *tfm.kernel_widths(cfg.nerf)).kind \
            in ('single', 'layered')
    assert routes == {('single', 3), ('single', 2), ('layered', 0)}


def test_route_plan_keeps_the_flagship_kernel():
    """At the flagship's shapes (8 x 256, multires 7 / 4, 16 framecode
    columns; and the surreal_single network) the plan is today's kernel:
    the single kernel at three weight stages, 2,000 bytes under the
    limit; the first versions keep refusing anything else."""
    ncfg = NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    route = tfr.route_plan(ncfg, *tfr.input_widths(7, 4)[0::2])
    assert (route.kind, route.stages, route.smem) == (
        'single', 3, tfr.SM90_MAX_SMEM - 2000)
    assert tfr.route_plan(ncfg, *tfm.kernel_widths(ncfg)).stages == 3
    single = dataclasses.replace(ncfg, input_ch_views=72)
    assert tfr.route_plan(single, *tfr.input_widths(7, 0)[0::2]).stages == 3
    for bad in (dataclasses.replace(ncfg, width=512),
                dataclasses.replace(ncfg, depth=40)):
        with pytest.raises(ValueError, match='first versions'):
            tfr._check_v1('v1', bad, 16)
    with pytest.raises(ValueError, match='first versions'):
        tfr._check_v1('v1', ncfg, 32)
    assert tfr.skip_flags(dataclasses.replace(ncfg, depth=5)) == [0] * 5
    assert tfr.skip_flags(ncfg) == [0, 0, 0, 0, 0, 1, 0, 0]
    assert sum(tfr.skip_flags(dataclasses.replace(
        ncfg, depth=40, skips=(4, 35)))) == 2


def test_route_plan_sends_k4_at_two_stages_to_the_layered_route():
    """K4 (`embedded`) takes the layered route where the single kernel
    fits at two weight stages only (the faster there on the card); at
    three stages, and for K1, K3 and K2's recompute, the plan is the
    single kernel's as before."""
    two = NeRFConfig(depth=8, width=256, input_ch=24 * 21, input_ch_bones=72,
                     input_ch_views=72 * 9, use_framecode=True,
                     framecode_ch=16, n_framecodes=4)
    k0, _, kv, _ = tfr.input_widths(10, 4)
    assert (tfr.route_plan(two, k0, kv).kind,
            tfr.route_plan(two, k0, kv).stages) == ('single', 2)
    k4 = tfr.route_plan(two, *tfm.kernel_widths(two), embedded=True)
    assert (k4.kind, k4.stages) == ('layered', 0) and 'K4' in k4.why
    flagship = dataclasses.replace(two, input_ch=360)
    assert tfr.route_plan(flagship, *tfm.kernel_widths(flagship),
                          embedded=True).stages == 3


def _grid_nets(with_bands=False):
    """(NeRFConfig, K1's k0 and kv[, (nfk, nfv)]) of every config the
    GRID's gate admits (the width 384 the factory refuses left out)."""
    for width, depth, fc, mr, mv in GRID:
        if width == 384:
            continue
        args = TorchTrainConfig(**dataclasses.asdict(
            _gate_args(width, depth, fc, mr, mv, fused_kernel=True)))
        cfg = t_build(args, _data_attrs())
        k0, _, kv, _ = tfr.input_widths(mr, mv, tfr.fc_width(cfg.nerf))
        yield (cfg.nerf, k0, kv) + (((mr, mv),) if with_bands else ())


def test_layered_plan_covers_every_admitted_config():
    """The layered route's plan (`layered_plan`, the mirror of the CUDA
    host code) at every config the gate admits, for K1 / K3, K2's
    recompute and K4's own input widths: each layer's shared memory fits
    a block, its output blocks cover its N outputs with no block to
    spare, its A segments' k-slices are the weight image's slices of that
    layer, its output columns lie inside the activation buffer, and it
    runs clusters of LAYERED_CLUSTER CTAs only where the points make at
    least that many tiles."""
    n_configs = 0
    for ncfg, k0, kv, nf in _grid_nets(with_bands=True):
        n_configs += 1
        for (a, b), save, embedded in (((k0, kv), False, False),
                                       ((k0, kv), True, False),
                                       (tfm.kernel_widths(ncfg), False,
                                        True)):
            plan = tfr.layered_plan(ncfg, a, b, save, embedded)
            shapes = tfr.sm90_shapes(ncfg, a, b)
            width = {'X': tfr.layered_columns(ncfg, a, b, save, embedded),
                     'act': tfr.act_rows(ncfg, *nf)['F']}
            assert len(plan) == len(shapes) == ncfg.depth + 2
            for layer, (N, K) in zip(plan, shapes):
                assert layer['N'] == N
                assert layer['smem'] <= tfr.SM90_MAX_SMEM
                assert layer['stages'] == tfr.LAYERED_MAX_STAGES
                assert layer['blocks'] * layer['block'] >= N \
                    > (layer['blocks'] - 1) * layer['block']
                assert layer['k_slices'] == K // tfr.SLICE_K == sum(
                    n for *_, n in layer['segments'])
                assert [dst for dst, _ in layer['out']] in (
                    (['act'], ['act', 'X']) if save else (['X'],))
                for dst, col in layer['out']:
                    assert col + N <= width[dst]
                for src, col, n in layer['segments']:
                    assert src in (('X', 'x0', 'xv') if embedded
                                   else ('act',) if save else ('X',))
                    if src in width:
                        assert col + n * tfr.SLICE_K <= width[src]
                assert layer['cluster'] == tfr.LAYERED_CLUSTER
        for n_points in (1, 64, tfr.LAYERED_GM, tfr.LAYERED_GM + 1, 294912):
            tiles = -(-n_points // tfr.LAYERED_GM)
            for layer in tfr.layered_plan(ncfg, k0, kv, False, False,
                                          n_points):
                assert layer['cluster'] == (
                    tfr.LAYERED_CLUSTER if tiles >= tfr.LAYERED_CLUSTER
                    else 1)
    assert n_configs == len(GRID) // 4 * 3


def _source_int(name):
    import re
    text = (tfr._CSRC / 'fused_render_layered_sm90.cu').read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def test_layered_plan_follows_the_kernel_source():
    """The mirror's constants are the kernel's, and its shared memory is
    the sum the layout gives: 256-wide blocks, four stages of a 128 x 64
    A slice and a 256 x 64 B slice, two warpgroups' 64 staged rows of 128
    bf16, 1,024 bytes of alignment, two barriers a stage (1,984 bytes to
    spare); 128-wide blocks four stages. At wide-net the view layer
    reads the feature rows and the 11 slices of xv; the trunk's outputs
    alternate between two buffers after x0 | xv. K2's recompute keeps
    every activation in its act layout (`act_rows`' feature rows), where
    the layers read them, and writes the last trunk layer and hv into X
    as well, the heads' inputs (X: 768 columns)."""
    for name, value in (('GM', tfr.LAYERED_GM),
                        ('GCL', tfr.LAYERED_CLUSTER),
                        ('MAX_STAGES', tfr.LAYERED_MAX_STAGES),
                        ('STG_COLS', tfr.LAYERED_STG_COLS)):
        assert _source_int(name) == value, name
    assert tfr.layered_gemm_smem(256) == (
        4, 1024 + 4 * (16384 + 32768) + 2 * 64 * 128 * 2 + 4 * 16)
    assert tfr.layered_gemm_smem(256)[1] == tfr.SM90_MAX_SMEM - 1984
    assert tfr.layered_gemm_smem(128) == (
        4, 1024 + 4 * (16384 + 16384) + 2 * 64 * 128 * 2 + 4 * 16)
    ncfg = NeRFConfig(depth=8, width=512, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    k0, _, kv, _ = tfr.input_widths(7, 4)
    plan = tfr.layered_plan(ncfg, k0, kv, False, False)
    x0w, xvw = 448, 704
    assert [p['out'] for p in plan[:8]] == [[('X', x0w + xvw + 512 * (i & 1))]
                                            for i in range(8)]
    assert plan[5]['segments'] == [('X', 0, 7), ('X', x0w + xvw, 8)]
    assert plan[-1]['segments'] == [('X', x0w + xvw, 8), ('X', x0w, 11)]
    assert (plan[-1]['block'], plan[-1]['blocks']) == (256, 1)
    assert (plan[0]['block'], plan[0]['blocks']) == (256, 2)
    rows = tfr.act_rows(ncfg, 7, 4)
    save = tfr.layered_plan(ncfg, k0, kv, True, False)
    assert [p['out'] for p in save] == [
        [('act', rows['h'] + 512 * i)] for i in range(7)] + [
        [('act', rows['h'] + 512 * 7), ('X', 0)], [('act', rows['feat'])],
        [('act', rows['hv']), ('X', 512)]]
    assert save[5]['segments'] == [('act', 0, 7),
                                   ('act', rows['h'] + 512 * 4, 8)]
    assert save[-1]['segments'] == [('act', rows['feat'], 8),
                                    ('act', rows['xv'], 11)]
    assert tfr.layered_columns(ncfg, k0, kv, True, False) == 768
    wide_in = NeRFConfig(depth=8, width=256, input_ch=24 * 21,
                         input_ch_bones=72, input_ch_views=72 * 13,
                         use_framecode=True, framecode_ch=32, n_framecodes=4)
    view = tfr.layered_plan(wide_in, 576, 968, False, False)[-1]
    assert (view['N'], view['block'], view['stages']) == (128, 128, 4)


def test_layered_design_bytes_counts_the_layout():
    """roofline.layered_design_bytes and layered_launch_bytes against the
    count written out from the layered route's layout (x0 | xv |
    activations) a point, layer by layer, at wide-net (8 x 512, inputs
    432 and 664 columns, 448 and 704 padded) and wide-input (8 x 256, 576
    and 968, 576 and 1024 padded), skip into layer 5. K4 reads its inputs
    in place (k0 and kv columns) and no cutoff distances; K1 reads its
    points (12 bytes) and writes x0 | xv; K2's recompute writes every
    activation once, into its act layout, and the last trunk layer and hv
    into X as well (no copy). Each launch carries its own weights (bf16,
    unpadded), biases and the heads' and phase A's f32 operands. (K4's
    counts are the 23.6 and 14.5 KB a point of the layered route's HBM
    floor.)"""
    def count(w, x0, xv, emb_x0, emb_xv, embedded, save):
        a0, av = (emb_x0, emb_xv) if embedded else (x0, xv)
        per = [] if embedded else [12 + 2 * (x0 + xv)]       # phase A
        per += [2 * (a0 + w)]                                # layer 0
        per += [2 * (w + w)] * 4                             # 1-4
        per += [2 * (a0 + w + w)]                            # 5: skip
        per += [2 * (w + w), 2 * (w + w + w * save)]         # 6, 7
        per += [2 * (w + w)]                                 # feature
        per += [2 * (w + av + w // 2 + w // 2 * save)]       # view
        per += [2 * (w // 2 + w) + 16]                       # heads
        return per

    from anerf_torch.kernels import roofline as rf
    for name, w, (k0, kv), (x0, xv), want_k4 in (
            ('wide-net', 512, (432, 664), (448, 704), 23552),
            ('wide-input', 256, (576, 968), (576, 1024), 14496)):
        ncfg, _, _ = rf.shape_config(name)
        ks = [k0] + [w] * 4 + [k0 + w] + [w] * 3 + [w + kv]
        weights = [2 * k * n + 4 * n for k, n in zip(ks, [w] * 9 + [w // 2])]
        heads = 4 * (3 * (w // 2) + w + 4)
        for embedded, save in ((True, False), (False, False),
                               (False, True)):
            launches = rf.layered_launch_bytes(ncfg, k0, kv, 1000, save,
                                               embedded)
            per = count(w, x0, xv, k0, kv, embedded, save)
            own = ([] if embedded else [4 * 24]) + weights + [heads]
            assert [b for _, b in launches] == [
                p * 1000 + o for p, o in zip(per, own)], (name, embedded)
            assert [lab for lab, _ in launches] == (
                [] if embedded else ['phase A']) + [
                f'layer {i}' for i in range(8)] + ['feature', 'view',
                                                   'heads']
            got = rf.layered_design_bytes(ncfg, k0, kv, 1000, save,
                                          embedded)
            assert got == sum(per) * 1000 + rf.net_bytes(ncfg) - (
                4 * 24 if embedded else 0), (name, embedded)
            if embedded:
                assert sum(per) == want_k4
        assert tfr.layered_columns(ncfg, k0, kv, True, False) == \
            w + w // 2


# ------------------------------------------------ the kernels at a shape

def _setup(name, seed=0):
    """One SHAPES config in both packages, R rays x S samples, and a
    seeded cotangent weight. The weights are the port's initialisation
    from a seeded generator, handed to JAX as the same numbers (JAX's
    own initialisation compiles anew for every shape)."""
    rng = np.random.default_rng(seed)
    args = tiny_args(compute_dtype='bfloat16', **SHAPES[name])
    pose = _pose_data(rng)
    cfg = j_build(args, dict(_data_attrs(8), rest_pose=pose['rest_pose']))
    targs = TorchTrainConfig(**dataclasses.asdict(args))
    tcfg = t_build(targs, _data_attrs(8))
    tparams = t_init(targs, tcfg, torch.Generator().manual_seed(seed),
                     device='cpu')
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tparams)
    batch = synthetic_batch(rng, pose, n_rays=R, n_images=4)
    rays_o, rays_d = batch['rays'][:, :3], batch['rays'][:, 3:6]
    pts = rays_o[:, None] + rays_d[:, None] * jnp.linspace(1.0, 3.0, S)[
        None, :, None]
    fc = lookup_framecodes(params['coarse'], batch['cam_idxs'])
    gw = np.random.default_rng(7).normal(size=(R, S, 4)).astype(np.float32)
    return dict(args=args, cfg=cfg, params=params, tcfg=tcfg,
                tparams=tparams, batch=batch, pts=pts, rays_d=rays_d,
                skts=batch['skts'][batch['pose_idx']], fc=fc, gw=gw,
                nf=(args.multires, args.multires_views))


_SETUPS = {}


def _shape(name):
    if name not in _SETUPS:
        _SETUPS[name] = _setup(name)
    return _SETUPS[name]


FORWARD_SHAPES = ['wide-net-8', 'wide-input', 'depth-5', 'depth-40']


def _jax_forwards(s, x0, xv, tau):
    """JAX's K1 on the points, K3 on their raw rows and K4 on (x0, xv),
    packing included, as one jitted function: one compile of the three
    interpret-mode kernels in place of an op-by-op run (the packing's
    alone took seconds at 8 x 512)."""
    ncfg, (nfk, nfv) = s['cfg'].nerf, s['nf']

    def run(params, cutoff, pts, rays_d, skts, fc, x0, xv, tau):
        packed = jfr.pack_render_params(params, ncfg, nfk, nfv, cutoff)
        m_all, aux = jfr.pack_ray_data(rays_d[:, None], skts, fc)
        k1 = jfr.fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)
        x = jfr.build_raw_inputs(pts, rays_d[:, None], skts, fc)
        k3 = jfr.fused_encode_mlp(ncfg, packed, x.reshape(R * S, -1), 256,
                                  tau)
        net = {k: v for k, v in params.items() if k != 'framecodes'}
        k4 = jfm.fused_mlp_apply(ncfg, jfm.pack_params(net, ncfg), x0, xv,
                                 256)
        return k1, k3, k4

    return [np.asarray(a) for a in jax.jit(run)(
        s['params']['coarse'], s['params']['cutoff_dist'], s['pts'],
        s['rays_d'], s['skts'], s['fc'], jnp.asarray(x0), jnp.asarray(xv),
        jnp.float32(tau))]


@pytest.mark.parametrize('name', FORWARD_SHAPES)
def test_plain_k1_k3_k4_match_pallas(name):
    """K1, K3 and K4's plain versions against the Pallas kernels in
    interpret mode on the same weights and points (K4 on the plain K1's
    embedded inputs), tau = 35."""
    s = _shape(name)
    ncfg, tau = s['tcfg'].nerf, 35.0
    packed = tfr.pack_render_params(s['tparams']['coarse'], ncfg, *s['nf'],
                                    s['tparams']['cutoff_dist'])
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], _t(s['skts']),
                                   _t(s['fc']))
    x0, xv = tfr._encode(packed, _t(s['pts']), m_all, aux, S, tau)
    k0, kv = ncfg.dnet_input, tfm.view_in(ncfg)
    x0 = x0[..., :k0].reshape(R * S, k0)
    xv = xv[..., :kv].reshape(R * S, kv)
    want, want3, want4 = _jax_forwards(s, x0.numpy(), xv.numpy(), tau)

    got = tfr.fused_encode_mlp_pts(ncfg, packed, _t(s['pts']), m_all, aux,
                                   S, tau)
    assert got.shape == (R, S, 4) and tfr.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), want, **CROSS)

    x_raw = tfr.build_raw_inputs(_t(s['pts']), _t(s['rays_d'])[:, None],
                                 _t(s['skts']), _t(s['fc']))
    assert x_raw.shape[-1] == tfr.raw_width(tfr.fc_width(ncfg))
    got3 = tfr.fused_encode_mlp(ncfg, packed, x_raw, tau)
    np.testing.assert_allclose(got3.numpy().reshape(R * S, 4), want3,
                               **CROSS)

    got4 = tfm.fused_mlp_apply(ncfg, tfm.pack_params(
        s['tparams']['coarse'], ncfg), x0, xv)
    np.testing.assert_allclose(got4.numpy(), want4, **CROSS)


def test_skip_after_the_last_layer_feeds_no_layer():
    """Depth 5 with the factory's skip after layer 4: JAX's kernel (and
    so the port's fused branch) runs a plain trunk of five layers, while
    JAX's XLA path concatenates the inputs after the last layer and fails
    on the feature layer's shape; the port's plain branch does the same.
    (ROADMAP, found in the JAX package by the port.)"""
    s = _shape('depth-5')
    assert s['cfg'].nerf.skips == (4,) and s['cfg'].nerf.depth == 5
    tau = jnp.float32(35.0)
    pr = lambda k: s['batch'][k][s['batch']['pose_idx']]
    enc = jax.jit(lambda *a: encode_inputs(s['cfg'], *a, None))(
        s['pts'], s['rays_d'][:, None], pr('kp3d'), s['skts'], pr('bones'),
        s['params']['cutoff_dist'], tau)
    with pytest.raises(TypeError):
        run_network(s['cfg'], s['params']['coarse'], enc, s['fc'])
    from anerf_torch.render.raycaster import encode_inputs as t_encode
    from anerf_torch.render.raycaster import run_network as t_run
    tp = s['tparams']
    tenc = t_encode(s['tcfg'], _t(s['pts']), _t(s['rays_d'])[:, None],
                    _t(pr('kp3d')), _t(s['skts']), _t(pr('bones')),
                    tp['cutoff_dist'], 35.0, None)
    with pytest.raises(RuntimeError):
        t_run(s['tcfg'], tp['coarse'], tenc, _t(s['fc']))
    assert tfr.skip_flags(s['tcfg'].nerf) == [0] * 5


class _FakeRef:
    """Array-as-ref shim: runs the JAX kernel's tile functions as plain
    jnp (tests/test_fused_render.py's oracle)."""

    def __init__(self, arr):
        self.arr = jnp.asarray(arr)

    def __getitem__(self, idx):
        return self.arr[idx]


def _jax_trace(s, packed):
    """The JAX kernel's recompute of the points (`_transform_tile` and
    `_forward_trace` as the backward kernel runs them) in the port's
    trace layout (`fused_render._forward_trace`): x0 = [v | sin, cos per
    band | bone dirs], xv = [d | sin, cos per band | fc], each padded to
    16, the bf16 activations, and the raw output."""
    cfg = s['cfg']
    nfk, nfv = s['nf']

    def trace(params, cutoff, pts, rays_d, skts, fc):
        # jitted: one compile in place of an op-by-op run
        jpacked = jfr.pack_render_params(params, cfg.nerf, nfk, nfv, cutoff)
        jm, ja = jfr.pack_ray_data(rays_d[:, None], skts, fc)
        w = {n: jpacked[n] for n in jfr._names(cfg.nerf)}
        t = jfr._transform_tile(S, R, _FakeRef(jnp.reshape(pts, (R * S, 3))),
                                _FakeRef(jm), _FakeRef(ja))
        return jfr._forward_trace(cfg.nerf, w, t['v'], t['r'], t['d'],
                                  t['fc'], jnp.float32(35.0))

    if 'jax_trace' not in s:        # both flavours' tests read it
        s['jax_trace'] = jax.jit(trace)(
            s['params']['coarse'], s['params']['cutoff_dist'], s['pts'],
            s['rays_d'], s['skts'], s['fc'])
    out, c = s['jax_trace']
    f = lambda a: torch.as_tensor(np.array(a, np.float32))
    J, C = 24, 72
    fcw = tfr.fc_width(s['tcfg'].nerf)
    _, k0p, _, kvp = tfr.input_widths(nfk, nfv, fcw)
    x0 = [f(c['vraw'])[:, :J]]
    for k in range(nfk):
        x0 += [f(c['sv'])[:, J * k:J * k + J], f(c['cv'])[:, J * k:J * k + J]]
    x0.append(f(c['rb'])[:, :C])
    xv = [f(c['draw'])[:, :C]]
    for k in range(nfv):
        xv += [f(c['sd'])[:, C * k:C * k + C], f(c['cd'])[:, C * k:C * k + C]]
    xv.append(f(c['fcb'])[:, :fcw])
    pad = lambda xs, n: torch.nn.functional.pad(torch.cat(xs, -1),
                                                (0, n - sum(x.shape[-1]
                                                            for x in xs)))
    W = s['tcfg'].nerf.width
    return {'x0': pad(x0, k0p), 'xv': pad(xv, kvp),
            'hs': [f(h) for h in c['hbs']], 'feat': f(c['featb']),
            'hv': f(c['hvb'])[:, :W // 2],
            'ws': tfr._weights_f32(s['tcfg'].nerf, packed),
            'out': f(out)[:, :4].reshape(R, S, 4)}


def _jax_grads(s, bwd_f32):
    """JAX fused_apply VJP w.r.t. the net's params, pts, skts and the
    framecodes (tests/test_torch_fused_bwd.py's `_jax_grads`)."""
    cfg, params = s['cfg'], s['params']
    nfk, nfv = s['nf']
    net = {k: v for k, v in params['coarse'].items() if k != 'framecodes'}
    cams = s['batch']['cam_idxs']

    def loss(p, pts, skts, codes):
        full = dict(p, framecodes={'codes': codes})
        fc = lookup_framecodes(full, cams)
        packed = jfr.pack_render_params(full, cfg.nerf, nfk, nfv,
                                        params['cutoff_dist'])
        m_all, aux = jfr.pack_ray_data(s['rays_d'][:, None], skts, fc)
        out = jfr.fused_apply(cfg.nerf, S, bwd_f32, packed, pts, m_all,
                              aux, jnp.float32(35.0))
        return jnp.sum(out * s['gw'])

    # jitted: the interpret-mode backward compiles in a third of the time
    # it takes to run op by op
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        net, s['pts'], s['skts'], params['coarse']['framecodes']['codes'])


def _torch_grads(s, bwd_f32):
    tcfg, tnet = s['tcfg'], s['tparams']['coarse']
    nfk, nfv = s['nf']
    leaves = [x.clone().requires_grad_()
              for x in tfr._net_leaves(tcfg.nerf, tnet)]
    pts = _t(s['pts']).requires_grad_()
    skts = _t(s['skts']).requires_grad_()
    codes = tnet['framecodes']['codes'].clone().requires_grad_()
    fc = codes[_t(s['batch']['cam_idxs']).long()]
    m_all, aux = tfr.pack_ray_data(_t(s['rays_d'])[:, None], skts, fc)
    out = tfr.fused_apply(tcfg.nerf, S, tfr._net_from_leaves(tcfg.nerf,
                                                             leaves),
                          s['tparams']['cutoff_dist'], nfk, nfv, pts, m_all,
                          aux, 35.0, bwd_f32)
    (out * _t(s['gw'])).sum().backward()
    return [x.grad for x in leaves], pts.grad, skts.grad, codes.grad


@pytest.mark.parametrize('name,bwd_f32', [('wide-net-8', True),
                                          ('wide-net-8', False),
                                          ('wide-input', True),
                                          ('wide-input', False)])
def test_plain_k2_matches_jax_vjp(name, bwd_f32, monkeypatch):
    """K2's plain version (through FusedApply) in both flavours against
    the JAX fused_apply VJP in the same flavour, both backwards on the
    JAX kernel's recompute: every parameter leaf, the points, skts and
    the framecodes within K2_FRO."""
    s = _shape(name)
    jg = _jax_grads(s, bwd_f32)
    packed = tfr.pack_render_params(s['tparams']['coarse'], s['tcfg'].nerf,
                                    *s['nf'], s['tparams']['cutoff_dist'])
    trace = _jax_trace(s, packed)
    monkeypatch.setattr(tfr, '_forward_trace', lambda *a: trace)
    leaves, dpts, dskts, dcodes = _torch_grads(s, bwd_f32)
    jleaves = tfr._net_leaves(s['tcfg'].nerf, params_from_numpy(
        jax.tree.map(np.asarray, dict(jg[0], framecodes={'codes': jg[3]})),
        'cpu'))
    assert len(leaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        assert a.shape == b.shape
        assert _relfro(a.numpy(), b.numpy()) < K2_FRO, i
    for a, b in ((dpts, jg[1]), (dskts, jg[2]), (dcodes, jg[3])):
        assert _relfro(a.numpy(), np.asarray(b)) < K2_FRO
    assert tfr.BWD_LAUNCHES == tfr.BWD_BF16_LAUNCHES == 0


# ----------------------------------------------------------- the step

def test_train_step_matches_jax_at_wide_net():
    """One make_train_step step on the fused branch at 4 x 512 (16 rays,
    8 + 4 samples, pose refinement) against JAX's make_train_step(raw=
    True) with its kernels in interpret mode, as tests/test_torch_train.py
    holds the flagship's."""
    rng = np.random.default_rng(0)
    args = tiny_args(compute_dtype='bfloat16', N_samples=8, N_importance=4,
                     opt_pose=True, opt_rot6d=True, opt_pose_step=2,
                     opt_pose_coef=2.0, opt_pose_tol=0.01,
                     **SHAPES['wide-net'])
    pose = _pose_data(rng)
    cfg = j_build(args, dict(_data_attrs(8), rest_pose=pose['rest_pose']))
    targs = TorchTrainConfig(**dataclasses.asdict(args))
    tparams = t_init(targs, t_build(targs, _data_attrs(8)),
                     torch.Generator().manual_seed(0), device='cpu')
    for net in ('coarse', 'fine'):
        tparams[net]['alpha_linear']['b'] += 2.0
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tparams)
    batch = synthetic_batch(rng, pose, n_rays=16, n_images=4)
    jcfg = dataclasses.replace(cfg.test_mode(), use_fused=True)
    jpc = jpose.PoseOptConfig(use_rot6d=True)
    opt = jst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                  args.lrate_decay_rate, args.decay_unit)
    popt = jst.make_pose_optimizer(args.opt_pose_lrate,
                                   args.opt_pose_lrate_decay,
                                   args.opt_pose_decay_rate,
                                   args.opt_pose_decay_unit)
    pose_params = jpose.init_pose_params(pose['kp3d'], pose['bones'], jpc)
    pose_opt_state, pose_acc = jst.init_pose_opt_state(popt, pose_params)
    jstate = jst.TrainState(
        step=jnp.int32(0), params=params,
        opt_state=jst.init_opt_state(opt, params), pose_params=pose_params,
        pose_opt_state=pose_opt_state, pose_grad_acc=pose_acc,
        anchors=jpose.pose_anchor_tree(pose['kp3d'], pose['bones']))
    jstep = j_make_train_step(args, jcfg, jpc, jnp.asarray(pose['rest_pose']),
                              opt, popt, raw=True, tau_fixed=35.0)
    jnew, jout = jax.jit(jstep)(jstate, batch, jax.random.PRNGKey(0))

    tcfg = dataclasses.replace(t_build(targs, _data_attrs(8)).test_mode(),
                               use_fused=True)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    topt = tst.make_nerf_optimizer(args.lrate, args.lrate_decay,
                                   args.lrate_decay_rate, args.decay_unit)
    tpopt = tst.make_pose_optimizer(args.opt_pose_lrate,
                                    args.opt_pose_lrate_decay,
                                    args.opt_pose_decay_rate,
                                    args.opt_pose_decay_unit)
    step = make_train_step(targs, tcfg, tpose.PoseOptConfig(use_rot6d=True),
                           _t(pose['rest_pose']), topt, tpopt,
                           tau_fixed=35.0)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for k in ('cam_idxs', 'pose_idx', 'kp_idxs'):
        tbatch[k] = tbatch[k].long()
    new, out = step(state, tbatch, None)
    for grp in ('losses', 'stats'):
        for k, v in jout[grp].items():
            a, b = float(v), float(out[grp][k])
            if k == 'MPJPC':
                assert abs(a - b) < 1e-5, (k, a, b)
            else:
                assert abs(a - b) <= 1e-4 * max(abs(a), 1e-6), (k, a, b)
    mu_j = np.asarray(jnew.opt_state[0].mu, np.float64)
    mu_t = new.opt_state.mu.numpy().astype(np.float64)
    assert np.abs(mu_t - mu_j).max() / np.abs(mu_j).max() < 2e-2
    # the stepped parameters land where JAX puts them
    got, want = tst.flatten_tree(new.params).numpy(), np.asarray(
        ravel_pytree(jnew.params)[0])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3
