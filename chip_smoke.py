"""Smoke test of the PyTorch / CUDA port (anerf_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result):
  1. device: needs CUDA; prints the card and its power limit, turns TF32
     off, builds the hand-written kernels from the checkout (one nvcc per
     source, started together; sm_90a).
  2. kernels: K1 (fused_encode_mlp_pts) against its plain PyTorch version
     at the flagship width on one 4096-ray bucket, S = 64 and S = 80,
     tau = 2000 and 35; error against a stated tolerance, median times
     (CUDA events, inputs varied between reps) beside the bound. K2
     (fused_bwd) the same way on one training batch (2048 rays, S = 64 on
     the coarse net and S = 80 on the fine net), every output held against
     its plain version, and a second launch on the same inputs held to
     the same bits.
  3. render slice: the flagship SURREAL model (random weights from a seed,
     fused_kernel on, chunk 4096) answers three render_path requests at
     512 x 512 (bullet time of one pose, two selected poses, the bullet
     time again); each is checked for finite output and for two K1
     launches per ray bucket. A small ray batch through render_rays on the
     fused branch is held against the plain-torch branch.
  4. train slice: one step's gradients on the fused branch (K1 + K2) held
     against the plain-torch branch on 256 rays; then 20 train steps of
     the flagship (N_rand 2048, 128 frames, pose refinement) through
     make_train_step, checked for finite and falling loss, acc in [0, 1],
     two K1 and two K2 launches per step, and poses that move only on
     their opt_pose_step interval.
With --profile, one request and one train step run again under
torch.profiler, and for each the device-busy share and the top kernels
by device time are printed.
The last lines are a JSON `kernels` record, the card line, and
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

# the driver's budget is 1200 s; this script aims to finish in well under
# half of it
H = W = 512                     # the requests' image size
# K1 vs its plain version: both round the same activations to bf16, so
# they differ only by fp32 summation order and sin/cos ulps, which flip an
# occasional bf16 rounding; observed max 5.0e-4 abs on an H100 (raw values
# up to ~2). 2e-3 keeps a 4x margin (the JAX fused-vs-XLA bound is 3e-2).
K1_ATOL = K1_RTOL = 2e-3
# render_rays through K1 vs the plain-torch branch, which rounds each
# layer's product to bf16 as XLA does: observed 4e-5 on rgb / acc.
SLICE_ATOL = SLICE_RTOL = 5e-3
# K2 vs its plain version, on every output (each dW block, dpts, dm_all,
# daux): 2e-2 relative in the Frobenius norm (the JAX kernel-vs-oracle
# bound, tests/test_fused_render.py:119) and 0.12 relative max with the
# denominator floored at 1e-7 (the JAX fused-vs-XLA gradient bound,
# tests/test_fused_render.py:260). K2's recompute and the plain version
# sum in another order, so across a batch's 10^5 points a few
# pre-activations land on the other side of 0 or of a bf16 rounding
# step and flip a ReLU mask. That moves one point's cotangent by a whole
# unit's contribution, and at tau = 2000 the window derivative (up to
# tau / 4 = 500) multiplies it into that point's dpts and its ray's
# dm_all / daux. The run prints how many rays are off by more than
# K2_RTOL of the largest value.
K2_RTOL = 2e-2
K2_FRO = 2e-2
K2_BLOCK_RTOL = 0.12
# one train step's gradients, fused branch vs plain branch: the bound of
# the JAX package's fused-vs-XLA gradient test
# (tests/test_fused_render.py:217-261)
STEP_GRAD_RTOL = 0.12
N_TRAIN_STEPS = 20


def _median_ms(fn, inputs, reps):
    import torch
    times = []
    for i in range(reps):
        args = inputs[i % len(inputs)]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def _flagship(torch, np, n_frames, **overrides):
    """__graft_entry__._flagship()'s TrainConfig with the fused kernel on
    (and `overrides` from configs/surreal/surreal.txt), its synthetic
    skeleton of `n_frames` frames (rest * 0.3, bones / pelvis from
    default_rng(0)) through the port's FK, and random weights from a
    seeded generator. Returns (args, cfg, params, rest, bones, kp3d)."""
    from anerf_torch.config import TrainConfig
    from anerf_torch.ops.fk import fk
    from anerf_torch.render.factory import (build_render_config,
                                            init_render_params)
    from anerf_torch.skeleton import SMPLSkeleton, smpl_rest_pose

    args = TrainConfig(**{**dict(
        netdepth=8, netwidth=256, multires=7, multires_views=4,
        N_samples=64, N_importance=16, N_rand=256, N_sample_images=4,
        use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
        cutoff_inputs=True, use_background=True, opt_framecode=True,
        ext_scale=0.001, raw_noise_std=1.0, compute_dtype='bfloat16',
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01, lrate_decay=500, fused_kernel=True), **overrides})
    rng = np.random.default_rng(0)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.2).astype(np.float32)
    kp3d = fk(torch.as_tensor(bones), torch.as_tensor(rest),
              torch.as_tensor(pelvis))[0].numpy()

    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': n_frames})
    params = init_render_params(args, cfg, torch.Generator().manual_seed(0),
                                device='cuda')
    # random weights put almost no density anywhere; lift the density
    # head's bias (as tests/test_mesh_render.py does) so the body shows up
    # in the images and the output checks are not vacuous
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] += 2.0
    return args, cfg, params, rest, bones, kp3d


def _flagship_render(torch, np):
    """The render slice's setup: _flagship on 8 frames at the render chunk
    of surreal.txt, a camera 2.5 units in front of each root.
    Returns (args, cfg, params, pose source)."""
    from anerf_torch.render.modes import PoseSource

    n_frames = 8
    args, cfg, params, rest, bones, kp3d = _flagship(torch, np, n_frames,
                                                     chunk=4096)
    # cameras 2.5 units in front of each root, looking at it (NeRF: -z)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    c2ws[:, :3, 3] = kp3d[:, 0] + np.array([0.0, 0.0, 2.5], np.float32)
    src = PoseSource(kps=kp3d, bones=bones, c2ws=c2ws,
                     focals=np.full((n_frames,), 500.0, np.float32),
                     rest_pose=rest)
    return args, cfg, params, src


def _bucket_inputs(torch, np, cfg, params, src, seed, R=4096):
    """One bucket of K1 operands as the main path builds them: R rays
    from a camera 2.5 units from the root of pose 0 toward the body,
    cylinder near/far, 64 stratified samples and the 64 + 16 fine set."""
    from anerf_torch.kernels.fused_render import pack_ray_data
    from anerf_torch.models.nerf import lookup_framecodes
    from anerf_torch.ops.cylinder import (get_kp_bounding_cylinder,
                                          get_near_far_in_cylinder)
    from anerf_torch.ops.fk import fk
    from anerf_torch.ops.sampling import sample_from_lineseg

    rng = np.random.default_rng(seed)
    dev = 'cuda'
    kp, skts, _, _ = fk(torch.as_tensor(src.bones[:1]),
                        torch.as_tensor(src.rest_pose),
                        torch.as_tensor(src.kps[:1, 0]
                                        - src.rest_pose[0]))
    root = kp[0, 0].numpy()
    o = root + np.array([0.0, 0.2, 2.5], np.float32)
    tgt = root + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    rays_o = torch.as_tensor(np.broadcast_to(o, (R, 3)).copy(), device=dev)
    rays_d = torch.as_tensor(tgt - o, device=dev)
    cyl = get_kp_bounding_cylinder(kp.numpy(), ext_scale=0.001, head='-y',
                                   extend_mm=250, top_expand_ratio=1.6,
                                   bot_expand_ratio=1.1)
    cyls = torch.as_tensor(cyl, device=dev).expand(R, 5)
    near, far = get_near_far_in_cylinder(rays_o, rays_d, cyls, 0.0, 1.0)
    z64 = sample_from_lineseg(near, far, 64)
    z16 = sample_from_lineseg(near, far, 16)
    pts64 = rays_o[:, None] + rays_d[:, None] * z64[..., None]
    pts80 = torch.cat([pts64, rays_o[:, None] + rays_d[:, None]
                       * z16[..., None]], 1)
    skts_r = skts.to(dev).expand(R, 24, 4, 4)
    fc = lookup_framecodes(params['coarse'],
                           torch.zeros(R, dtype=torch.long, device=dev))
    m_all, aux = pack_ray_data(rays_d[:, None], skts_r, fc)
    return {64: pts64.contiguous(), 80: pts80.contiguous()}, m_all, aux


def kernel_phase(torch, np, cfg, params, src):
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed)
                for seed in range(4)]
    max_abs, rec = 0.0, {}
    for S, net in ((64, 'coarse'), (80, 'fine')):
        for tau in (2000.0, 35.0):
            pts, m_all, aux = variants[0][0][S], variants[0][1], \
                variants[0][2]
            got = fr.fused_encode_mlp_pts(ncfg, packed[net], pts, m_all,
                                          aux, S, tau)
            torch.cuda.synchronize()
            want = fr.fused_encode_mlp_pts_ref(ncfg, packed[net], pts,
                                               m_all, aux, S, tau)
            err = (got - want).abs()
            rel = (err / want.abs().clamp_min(1e-6)).max().item()
            ok = torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
            print(f'K1 S={S} tau={tau:g}: max_abs={err.max().item():.3e} '
                  f'mean_abs={err.mean().item():.3e} max_rel={rel:.3e} '
                  f'|raw|max={want.abs().max().item():.3f} '
                  f'tol atol=rtol={K1_ATOL} -> {"ok" if ok else "FAIL"}',
                  flush=True)
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(f'K1 disagrees with its plain version '
                                     f'at S={S} tau={tau}')
            max_abs = max(max_abs, err.max().item())
        ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, 2000.0)
               for v in variants]
        rec[S] = (_median_ms(fr.fused_encode_mlp_pts, ins, 21),
                  _median_ms(fr.fused_encode_mlp_pts_ref, ins, 5))
        print(f'K1 S={S}: kernel {rec[S][0]:.4f} ms, plain '
              f'{rec[S][1]:.4f} ms (median, R=4096)', flush=True)

    R = 4096
    flops = 2.0 * rf.mlp_macs_per_point(ncfg) * R * (64 + 80)
    io_bytes = (R * (64 + 80) * (12 + 16)
                + 2 * (variants[0][1].numel() + variants[0][2].numel()) * 4
                + _packed_bytes(torch, packed))
    bound_ms, bound_by = rf.bound_ms({
        'bf16': flops / rf.PEAK_BF16_FLOPS,
        'bytes': io_bytes / rf.PEAK_HBM_BYTES})
    ms = rec[64][0] + rec[80][0]
    print(f'K1 bucket (S=64 + S=80): {flops / 1e12:.4f} TFLOP, '
          f'{io_bytes / 1e6:.2f} MB -> bound {bound_ms:.4f} ms '
          f'({bound_by}); kernel {ms:.4f} ms = {bound_ms / ms:.3f} of the '
          f'bound', flush=True)
    return {'name': 'fused_encode_mlp_pts', 'route': 'cuda',
            'source': 'anerf_torch/kernels/csrc/fused_render.cu',
            'replaces': 'anerf_tpu/kernels/fused_render.py:677',
            'launches': None, 'max_abs_err': max_abs, 'ms': ms,
            'plain_ms': rec[64][1] + rec[80][1], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None,
            'ms_s64': rec[64][0], 'ms_s80': rec[80][0]}


def _packed_bytes(torch, packed):
    """Bytes of both nets' kernel operands (weights, biases, heads)."""
    return sum(t.numel() * t.element_size()
               for net in ('coarse', 'fine')
               for t in packed[net].values() if torch.is_tensor(t))


def k2_phase(torch, np, cfg, params, src):
    """K2 on one training batch's operands: 2048 rays, the coarse net at
    S = 64 and the fine net at S = 80, tau = 2000 and 35, a seeded
    cotangent. Every output against the plain version, a second launch
    held to the same bits, median times beside the bound."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    R = 2048
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed, R=R)
                for seed in range(4)]
    gs = {S: [torch.as_tensor(
        np.random.default_rng(10 + i).normal(size=(R, S, 4)) * 0.1,
        dtype=torch.float32, device='cuda') for i in range(4)]
        for S in (64, 80)}
    names = ('dpts', 'dm_all', 'daux')
    max_abs, rec = 0.0, {}
    for S, net in ((64, 'coarse'), (80, 'fine')):
        for tau in (2000.0, 35.0):
            pts, m_all, aux = variants[0][0][S], variants[0][1], \
                variants[0][2]
            args = (ncfg, packed[net], pts, m_all, aux, S, tau, gs[S][0])
            got = fr.fused_bwd(*args)
            again = fr.fused_bwd(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f'K2 is not deterministic at S={S} '
                                     f'tau={tau}')
            want = fr.fused_bwd_ref(*args)
            gb = fr.split_grads(ncfg, packed[net]['nfk'],
                                packed[net]['nfv'], got[0])
            wb = fr.split_grads(ncfg, packed[net]['nfk'],
                                packed[net]['nfv'], want[0])
            worst_blk, worst_fro, worst_in = 0.0, 0.0, 0.0
            for name in wb:
                d = (gb[name] - wb[name]).abs()
                rel = (d.max() / wb[name].abs().max().clamp_min(1e-7)).item()
                fro = ((gb[name] - wb[name]).norm()
                       / wb[name].norm().clamp_min(1e-7)).item()
                worst_blk, worst_fro = max(worst_blk, rel), \
                    max(worst_fro, fro)
                max_abs = max(max_abs, d.max().item())
                if rel >= K2_BLOCK_RTOL or fro >= K2_FRO:
                    raise AssertionError(f'K2 dW block {name} disagrees '
                                         f'(rel {rel:.3e}, fro {fro:.3e}) '
                                         f'at S={S} tau={tau}')
            for name, a, b in zip(names, got[1:], want[1:]):
                d = (a - b).abs()
                top = b.abs().max().clamp_min(1e-7)
                rel = (d.max() / top).item()
                fro = ((a - b).norm() / b.norm().clamp_min(1e-7)).item()
                # rays (rows of dm_all / daux, ray slices of dpts) with an
                # entry off by more than K2_RTOL of the largest value
                off = (d.reshape(R, -1) > K2_RTOL * top).any(1).sum().item()
                worst_in = max(worst_in, rel)
                worst_fro = max(worst_fro, fro)
                max_abs = max(max_abs, d.max().item())
                print(f'K2 S={S} tau={tau:g}: {name} max_rel={rel:.3e} '
                      f'fro={fro:.3e} rays off by >{K2_RTOL}: {off}/{R} '
                      f'|max|={top.item():.3e}', flush=True)
                if not (rel < K2_BLOCK_RTOL and fro < K2_FRO
                        and torch.isfinite(a).all()):
                    raise AssertionError(f'K2 {name} disagrees with its '
                                         f'plain version at S={S} tau={tau}')
            print(f'K2 S={S} tau={tau:g}: dW blocks max_rel={worst_blk:.3e} '
                  f'(tol {K2_BLOCK_RTOL}); dpts / dm_all / daux max_rel='
                  f'{worst_in:.3e} (tol {K2_BLOCK_RTOL}); worst fro '
                  f'{worst_fro:.3e} (tol {K2_FRO}); two launches bitwise '
                  f'equal -> ok', flush=True)
            del got, again, want
        ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, 2000.0, g)
               for v, g in zip(variants, gs[S])]
        rec[S] = (_median_ms(fr.fused_bwd, ins, 11),
                  _median_ms(fr.fused_bwd_ref, ins, 3))
        print(f'K2 S={S}: kernel {rec[S][0]:.4f} ms, plain '
              f'{rec[S][1]:.4f} ms (median, R={R})', flush=True)

    P = R * (64 + 80)
    f32_flops = 2.0 * rf.bwd_f32_macs_per_point(ncfg) * P
    bf16_flops = 2.0 * rf.mlp_macs_per_point(ncfg) * P
    dw_bytes = 2 * 4 * sum(r * c for _, r, c in fr.grad_blocks(
        ncfg, packed['coarse']['nfk'], packed['coarse']['nfv']))
    io_bytes = (P * (12 + 16 + 12)
                + 2 * 2 * (variants[0][1].numel()
                           + variants[0][2].numel()) * 4
                + _packed_bytes(torch, packed) + dw_bytes)
    times = {'fp32': f32_flops / rf.PEAK_FP32_FLOPS,
             'bf16': bf16_flops / rf.PEAK_BF16_FLOPS,
             'bytes': io_bytes / rf.PEAK_HBM_BYTES}
    bound_ms, bound_by = rf.bound_ms(times)
    ms = rec[64][0] + rec[80][0]
    print(f'K2 step (S=64 + S=80, {R} rays): {f32_flops / 1e12:.4f} TFLOP '
          f'f32 ({times["fp32"] * 1e3:.4f} ms at 67 TFLOP/s; '
          f'{f32_flops / rf.PEAK_BF16_FLOPS * 1e3:.4f} ms at the bf16 '
          f'rate), {bf16_flops / 1e12:.4f} TFLOP bf16 recompute '
          f'({times["bf16"] * 1e3:.4f} ms), {io_bytes / 1e6:.2f} MB '
          f'({times["bytes"] * 1e3:.4f} ms) -> bound {bound_ms:.4f} ms '
          f'({bound_by}); kernel {ms:.4f} ms = {bound_ms / ms:.3f} of the '
          f'bound', flush=True)
    return {'name': 'fused_bwd', 'route': 'cuda',
            'source': 'anerf_torch/kernels/csrc/fused_render_bwd.cu',
            'replaces': 'anerf_tpu/kernels/fused_render.py:962',
            'launches': None, 'max_abs_err': max_abs, 'ms': ms,
            'plain_ms': rec[64][1] + rec[80][1], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None,
            'ms_s64': rec[64][0], 'ms_s80': rec[80][0]}


def reference_check(torch, np, cfg, params, src):
    """The rendered output against a reference: render_rays through K1 vs
    the plain-torch (XLA-mirror) branch on a small batch of rays aimed at
    the body of the bullet-time pose."""
    import dataclasses

    from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
    from anerf_torch.render import modes
    from anerf_torch.render.raycaster import render_rays

    bt = modes.load_bullettime(src, np.array([0]), n_bullet=4)
    dev = 'cuda'
    R = 256
    rng = np.random.default_rng(5)
    root = bt['kp3d'][0, 0]
    o = bt['c2ws'][0, :3, 3]
    tgt = root + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    d = (tgt - o).astype(np.float32)
    rays = np.concatenate([np.broadcast_to(o, (R, 3)), d,
                           np.zeros((R, 1)), np.ones((R, 1)),
                           d / np.linalg.norm(d, axis=-1, keepdims=True)],
                          -1).astype(np.float32)
    cyl = get_kp_bounding_cylinder(bt['kp3d'][:1], ext_scale=0.001,
                                   extend_mm=250, top_expand_ratio=1.6,
                                   bot_expand_ratio=1.1, head='-y')
    kw = dict(ray_batch=torch.as_tensor(rays, device=dev),
              kp_batch=torch.as_tensor(bt['kp3d'][:1], device=dev)
              .expand(R, 24, 3),
              skts=torch.as_tensor(bt['skts'][:1], device=dev)
              .expand(R, 24, 4, 4),
              bones=None,
              cyls=torch.as_tensor(cyl, device=dev).expand(R, 5),
              cam_idxs=torch.zeros(R, dtype=torch.long, device=dev),
              tau=2000.0)
    tcfg = cfg.test_mode()
    got = render_rays(params, tcfg, **kw)
    want = render_rays(params, dataclasses.replace(tcfg, use_fused=False),
                       **kw)
    for k in ('rgb_map', 'acc_map', 'rgb0', 'acc0'):
        err = (got[k] - want[k]).abs().max().item()
        ok = torch.allclose(got[k], want[k], atol=SLICE_ATOL,
                            rtol=SLICE_RTOL)
        print(f'render_rays fused vs plain branch ({R} rays): {k} '
              f'max_abs={err:.3e} -> {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'render_rays {k}: fused branch disagrees '
                                 'with the plain branch')


def _requests(np, src):
    from anerf_torch.render import modes
    return [
        ('bullet pose 0 x4', lambda: modes.load_bullettime(
            src, np.array([0]), n_bullet=4)),
        ('selected poses 1,2', lambda: modes.load_selected(
            src, np.array([1, 2]))),
        ('bullet pose 0 x4 again', lambda: modes.load_bullettime(
            src, np.array([0]), n_bullet=4)),
    ]


def _render(torch, args, cfg, params, data):
    """One request through render_path; returns (out, seconds)."""
    from anerf_torch.render.render_path import render_path
    t0 = time.perf_counter()
    out = render_path(params, cfg, data['c2ws'], (H, W, data['focals']),
                      data['kp3d'], data['skts'], data['bones'],
                      cam_idxs=data['cam_idxs'], tau=2000.0,
                      chunk=args.chunk, ext_scale=args.ext_scale,
                      white_bkgd=True, use_framecode_idx=args.opt_framecode)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice_phase(torch, np, args, cfg, params, src, k1_bucket_ms):
    """Three render_path requests through the fused branch; returns the
    K1 launches they made (counts are reset just before each request and
    read just after it)."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render.render_path import n_buckets_for

    launches = 0
    for name, build in _requests(np, src):
        data = build()
        fr.LAUNCHES = 0
        out, dt = _render(torch, args, cfg, params, data)
        got_launches = fr.LAUNCHES
        n_rays = [int((br[0] - tl[0]) * (br[1] - tl[1]))
                  for tl, br in out['bboxes']]
        buckets = sum(n_buckets_for(n, args.chunk) for n in n_rays if n)
        n_img = len(data['c2ws'])
        # K1's share of the request, from its median bucket time above
        k1_share = buckets * k1_bucket_ms / 1e3 / dt
        print(f'request "{name}": {n_img} images {H}x{W}, {sum(n_rays)} '
              f'box rays, {buckets} buckets, {got_launches} K1 launches, '
              f'{dt:.3f} s, {sum(n_rays) / dt:.1f} box-rays/s, '
              f'K1 ~{k1_share:.3f} of the time, '
              f'acc mean {out["accs"].mean():.4f}', flush=True)
        if out['rgbs'].shape != (n_img, H, W, 3):
            raise AssertionError(f'rgbs shape {out["rgbs"].shape}')
        if not np.isfinite(out['rgbs']).all():
            raise AssertionError('non-finite rgb')
        if out['accs'].min() < 0.0 or out['accs'].max() > 1.0:
            raise AssertionError('acc outside [0, 1]')
        if out['accs'].max() < 0.01:
            raise AssertionError('the body does not show up in the images')
        if got_launches != 2 * buckets or buckets == 0:
            raise AssertionError(f'{got_launches} K1 launches for '
                                 f'{buckets} buckets')
        launches += got_launches
    return launches


def _flagship_train(torch, np):
    """The train slice's setup: _flagship on 128 frames with N_rand 2048
    and N_sample_images 128 from configs/surreal/surreal.txt; one batch
    of 16 rays per frame aimed at its root (as __graft_entry__._batch
    aims them) with a constant gray target. Returns (args, cfg, pose
    config, rest pose, state, optimizers, batch)."""
    from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
    from anerf_torch.pose.pose_opt import (PoseOptConfig, init_pose_params,
                                           pose_anchor_tree)
    from anerf_torch.train.state import (TrainState, init_opt_state,
                                         init_pose_opt_state,
                                         make_nerf_optimizer,
                                         make_pose_optimizer)

    n_frames, n_rays = 128, 2048
    args, cfg, params, rest, bones, kp3d = _flagship(
        torch, np, n_frames, N_rand=n_rays, N_sample_images=n_frames)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=0.001, head='y')
    pose_cfg = PoseOptConfig(use_rot6d=True)
    opt = make_nerf_optimizer(args.lrate, args.lrate_decay,
                              args.lrate_decay_rate, args.decay_unit)
    popt = make_pose_optimizer(args.opt_pose_lrate,
                               args.opt_pose_lrate_decay,
                               args.opt_pose_decay_rate,
                               args.opt_pose_decay_unit)
    pose_params = init_pose_params(kp3d, bones, pose_cfg, device='cuda')
    pose_opt_state, pose_acc = init_pose_opt_state(popt, pose_params)
    state = TrainState(step=0, params=params,
                       opt_state=init_opt_state(opt, params),
                       pose_params=pose_params,
                       pose_opt_state=pose_opt_state,
                       pose_grad_acc=pose_acc,
                       anchors=pose_anchor_tree(kp3d, bones, 'cuda'))

    brng = np.random.default_rng(1)
    kp_idxs = brng.permutation(n_frames).astype(np.int64)
    pose_idx = np.repeat(np.arange(n_frames), n_rays // n_frames)
    roots = kp3d[kp_idxs][:, 0]
    rays_o = (roots + np.array([0.0, 0.2, 2.5], np.float32))[pose_idx]
    targets = roots[pose_idx] + brng.normal(
        size=(n_rays, 3)).astype(np.float32) * 0.3
    rays_d = targets - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays = np.concatenate([rays_o, rays_d, np.zeros((n_rays, 1)),
                           np.ones((n_rays, 1)), viewdirs], -1)
    dev = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device='cuda')
    batch = {'rays': dev(rays), 'target_s': dev(np.full((n_rays, 3), 0.3)),
             'fgs': dev(np.ones((n_rays, 1))),
             'bgs': dev(np.ones((n_rays, 3))),
             'cam_idxs': dev(kp_idxs[pose_idx], torch.long),
             'pose_idx': dev(pose_idx, torch.long),
             'kp_idxs': dev(kp_idxs, torch.long),
             'cyls': dev(cyls[kp_idxs])}
    return (args, cfg, pose_cfg, torch.as_tensor(rest, device='cuda'),
            state, opt, popt, batch)


def train_reference_check(torch, np, setup):
    """One step's gradients on 256 rays in test mode: every param leaf
    and the per-ray skts through the fused branch (K1 + K2) against the
    plain-torch branch; cutoff_dist gets no gradient on the fused
    branch."""
    import dataclasses

    from anerf_torch.pose.pose_opt import fk_lookup
    from anerf_torch.render.raycaster import render_rays
    from anerf_torch.train.state import tree_leaves
    from anerf_torch.train.trainer import derive_schedules

    args, cfg, pose_cfg, rest, state, _, _, batch = setup
    R = 256
    n_img = R // 16
    kp, bones, skts, _, _ = fk_lookup(state.pose_params,
                                      batch['kp_idxs'][:n_img], rest,
                                      pose_cfg)
    rep = lambda t: t.repeat_interleave(16, 0)
    tau, _ = derive_schedules(args, cfg, 0)
    grads = {}
    for fused in (True, False):
        tcfg = dataclasses.replace(cfg.test_mode(), use_fused=fused)
        leaves = tree_leaves(state.params)
        for x in leaves:
            x.requires_grad_(True)
        sk = rep(skts.detach()).requires_grad_(True)
        out = render_rays(state.params, tcfg, batch['rays'][:R], rep(kp),
                          sk, rep(bones), batch['cyls'][:n_img].
                          repeat_interleave(16, 0),
                          cam_idxs=batch['cam_idxs'][:R], tau=tau)
        loss = torch.mean((out['rgb_map'] - batch['target_s'][:R]) ** 2) \
            + torch.mean((out['rgb0'] - batch['target_s'][:R]) ** 2)
        grads[fused] = torch.autograd.grad(loss, leaves + [sk],
                                           allow_unused=True)
        for x in leaves:
            x.requires_grad_(False)
    # ravel order: 'coarse' leaves, then 'cutoff_dist', then 'fine'
    i_cut = len(tree_leaves(state.params['coarse']))
    worst = 0.0
    for i, (gf, gp) in enumerate(zip(grads[True], grads[False])):
        if i == i_cut:
            if gf is not None and gf.abs().max().item() != 0.0:
                raise AssertionError('cutoff_dist has a gradient on the '
                                     'fused branch')
            continue
        rel = ((gf - gp).abs().max()
               / gp.abs().max().clamp_min(1e-7)).item()
        worst = max(worst, rel)
        if not rel < STEP_GRAD_RTOL:
            raise AssertionError(f'step gradient {i} ({tuple(gp.shape)}): '
                                 f'fused vs plain {rel:.3e}')
    print(f'train step gradients, fused (K1 + K2) vs plain branch ({R} '
          f'rays, {len(grads[True])} leaves + skts): worst max_rel '
          f'{worst:.3e} (tol {STEP_GRAD_RTOL}), skts '
          f'{rel:.3e}; cutoff_dist gets no gradient -> ok', flush=True)


def train_phase(torch, np, setup, profile=False):
    """N_TRAIN_STEPS steps of make_train_step on the fused branch; the
    counts are set to 0 just before each step and read just after it.
    With `profile`, one more step runs under the profiler afterwards.
    Returns (K1 launches, K2 launches, median step seconds)."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.train.trainer import make_train_step

    args, cfg, pose_cfg, rest, state, opt, popt, batch = setup
    step = make_train_step(args, cfg, pose_cfg, rest, opt, popt)
    gen = torch.Generator(device='cuda').manual_seed(0)
    losses, times, k1, k2 = [], [], 0, 0
    for i in range(N_TRAIN_STEPS):
        pelvis = state.pose_params['pelvis'].clone()
        fr.LAUNCHES = fr.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        state, out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n1, n2 = fr.LAUNCHES, fr.BWD_LAUNCHES
        k1, k2 = k1 + n1, k2 + n2
        loss = out['losses']['total_loss'].item()
        acc = out['stats']['alpha'].item()
        moved = not torch.equal(pelvis, state.pose_params['pelvis'])
        losses.append(loss)
        print(f'train step {i}: loss {loss:.5f} psnr '
              f'{out["stats"]["psnr"].item():.3f} acc mean {acc:.4f} '
              f'kp_loss {out["losses"]["kp_loss"].item():.3e} '
              f'{times[-1] * 1e3:.1f} ms, K1 x{n1}, K2 x{n2}, poses '
              f'{"moved" if moved else "kept"}', flush=True)
        if not np.isfinite(loss) or not 0.0 <= acc <= 1.0:
            raise AssertionError(f'step {i}: loss {loss}, acc {acc}')
        if (n1, n2) != (2, 2):
            raise AssertionError(f'step {i}: {n1} K1 and {n2} K2 launches')
        if moved != (i % args.opt_pose_step == 0):
            raise AssertionError(f'step {i}: poses moved={moved} off their '
                                 f'interval')
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f'loss does not fall: {losses}')
    t = sorted(times[2:])[len(times[2:]) // 2]
    print(f'train: {N_TRAIN_STEPS} steps, loss {losses[0]:.5f} -> mean of '
          f'the last five {np.mean(losses[-5:]):.5f}; median step '
          f'{t * 1e3:.2f} ms = {args.N_rand / t:.1f} rays/s (steps 2..)',
          flush=True)
    if profile:
        profile_phase(torch, f'train step ({args.N_rand} rays)',
                      lambda: step(state, batch, gen))
    return k1, k2, t


def profile_phase(torch, label, fn):
    """With --profile: fn() once under torch.profiler; prints the
    device-busy share of the wall time and the kernels that take the
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side entries only: an aten op's device time is its
        # kernels', which appear as entries of their own
        dev_us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f'profile {label} (under the profiler): '
          f'wall {dt * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, '
          f'idle share {1.0 - busy_ms / (dt * 1e3):.3f}', flush=True)
    for dev_us, count, key in rows[:12]:
        print(f'  {dev_us / 1e3:10.3f} ms {100 * dev_us / 1e3 / busy_ms:5.1f}%'
              f' x{count:<6d} {key[:90]}', flush=True)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this check '
              'needs a GPU', file=sys.stderr)
        return 1
    import numpy as np

    from anerf_torch.kernels import fused_render as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn={torch.backends.cudnn.allow_tf32}', flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)

    t0 = time.perf_counter()
    for name, (path, log) in fr.build_libraries().items():
        print(f'built {path.name}', flush=True)
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas: {line.strip()}', flush=True)
    print(f'build took {time.perf_counter() - t0:.1f} s', flush=True)

    args, cfg, params, src = _flagship_render(torch, np)
    k1 = kernel_phase(torch, np, cfg, params, src)
    k2 = k2_phase(torch, np, cfg, params, src)
    reference_check(torch, np, cfg, params, src)
    render_k1 = slice_phase(torch, np, args, cfg, params, src, k1['ms'])
    if '--profile' in argv:
        name, build = _requests(np, src)[1]
        data = build()
        profile_phase(torch, f'request "{name}"',
                      lambda: _render(torch, args, cfg, params, data))
    setup = _flagship_train(torch, np)
    train_reference_check(torch, np, setup)
    train_k1, train_k2, step_s = train_phase(torch, np, setup,
                                              '--profile' in argv)
    k1['launches'] = render_k1 + train_k1
    k2['launches'] = train_k2
    print(f'launches on the main paths: K1 {render_k1} (render requests) + '
          f'{train_k1} (train steps), K2 {train_k2} (train steps)',
          flush=True)
    k2['step_ms'] = step_s * 1e3

    print(json.dumps({'kernels': [k1, k2]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
