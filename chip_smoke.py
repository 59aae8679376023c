"""Smoke test of the PyTorch / CUDA port (anerf_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result):
  1. device: needs CUDA; prints the card and its power limit, turns TF32
     off, builds the hand-written kernels from the checkout (nvcc, sm_90a).
  2. kernels: K1 (fused_encode_mlp_pts) against its plain PyTorch version
     at the flagship width on one 4096-ray bucket, S = 64 and S = 80,
     tau = 2000 and 35; error against a stated tolerance, median times
     (CUDA events, inputs varied between reps) beside the bound.
  3. slice: the flagship SURREAL model (random weights from a seed,
     fused_kernel on, chunk 4096) answers three render_path requests at
     512 x 512 (bullet time of one pose, two selected poses, the bullet
     time again); each is checked for finite output and for two K1
     launches per ray bucket. A small ray batch through render_rays on the
     fused branch is held against the plain-torch branch.
With --profile, one request runs again under torch.profiler and the
device-busy share and the top kernels by device time are printed.
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
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3
# K1 vs its plain version: both round the same activations to bf16, so
# they differ only by fp32 summation order and sin/cos ulps, which flip an
# occasional bf16 rounding; observed max 5.0e-4 abs on an H100 (raw values
# up to ~2). 2e-3 keeps a 4x margin (the JAX fused-vs-XLA bound is 3e-2).
K1_ATOL = K1_RTOL = 2e-3
# render_rays through K1 vs the plain-torch branch, which rounds each
# layer's product to bf16 as XLA does: observed 4e-5 on rgb / acc.
SLICE_ATOL = SLICE_RTOL = 5e-3


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


def _flagship(torch, np):
    """__graft_entry__._flagship()'s TrainConfig with the fused kernel on
    and the render chunk of configs/surreal/surreal.txt, its synthetic
    skeleton (rest * 0.3, bones / pelvis from default_rng(0)) through the
    port's FK, and random weights from a seeded generator."""
    from anerf_torch.config import TrainConfig
    from anerf_torch.ops.fk import fk
    from anerf_torch.render.factory import (build_render_config,
                                            init_render_params)
    from anerf_torch.render.modes import PoseSource
    from anerf_torch.skeleton import SMPLSkeleton, smpl_rest_pose

    n_frames = 8
    args = TrainConfig(
        netdepth=8, netwidth=256, multires=7, multires_views=4,
        N_samples=64, N_importance=16, N_rand=256, N_sample_images=4,
        use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
        cutoff_inputs=True, use_background=True, opt_framecode=True,
        ext_scale=0.001, raw_noise_std=1.0, compute_dtype='bfloat16',
        opt_pose=True, opt_rot6d=True, opt_pose_step=2, opt_pose_coef=2.0,
        opt_pose_tol=0.01, lrate_decay=500, fused_kernel=True, chunk=4096)
    rng = np.random.default_rng(0)
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.2).astype(np.float32)
    kp3d, skts, _, _ = fk(torch.as_tensor(bones), torch.as_tensor(rest),
                          torch.as_tensor(pelvis))
    kp3d = kp3d.numpy()

    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': n_frames})
    params = init_render_params(args, cfg, torch.Generator().manual_seed(0),
                                device='cuda')
    # random weights put almost no density anywhere; lift the density
    # head's bias (as tests/test_mesh_render.py does) so the body shows up
    # in the images and the output checks are not vacuous
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] += 2.0
    # cameras 2.5 units in front of each root, looking at it (NeRF: -z)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    c2ws[:, :3, 3] = kp3d[:, 0] + np.array([0.0, 0.0, 2.5], np.float32)
    src = PoseSource(kps=kp3d, bones=bones, c2ws=c2ws,
                     focals=np.full((n_frames,), 500.0, np.float32),
                     rest_pose=rest)
    return args, cfg, params, src


def _bucket_inputs(torch, np, cfg, params, src, seed):
    """One bucket of K1 operands as the main path builds them: 4096 rays
    from a camera 2.5 units from the root of pose 0 toward the body,
    cylinder near/far, 64 stratified samples and the 64 + 16 fine set."""
    from anerf_torch.kernels.fused_render import pack_ray_data
    from anerf_torch.models.nerf import lookup_framecodes
    from anerf_torch.ops.cylinder import (get_kp_bounding_cylinder,
                                          get_near_far_in_cylinder)
    from anerf_torch.ops.fk import fk
    from anerf_torch.ops.sampling import sample_from_lineseg

    R = 4096
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


def _k1_macs_per_point(ncfg):
    """Multiply-adds K1 does per point (unpadded widths)."""
    W = ncfg.width
    macs = ncfg.dnet_input * W
    for i in range(1, ncfg.depth):
        macs += ((ncfg.dnet_input + W) if (i - 1) in ncfg.skips else W) * W
    macs += W * W + ncfg.vnet_input * (W // 2) + (W // 2) * 3 + W
    return macs


def kernel_phase(torch, np, cfg, params, src):
    from anerf_torch.kernels import fused_render as fr
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
    flops = 2.0 * _k1_macs_per_point(ncfg) * R * (64 + 80)
    w_bytes = sum(t.numel() * t.element_size()
                  for net in ('coarse', 'fine')
                  for t in packed[net].values() if torch.is_tensor(t))
    io_bytes = (R * (64 + 80) * (12 + 16)
                + 2 * (variants[0][1].numel() + variants[0][2].numel()) * 4
                + w_bytes)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, io_bytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f'K1 bucket (S=64 + S=80): {flops / 1e12:.4f} TFLOP, '
          f'{io_bytes / 1e6:.2f} MB -> bound {bound_ms:.4f} ms '
          f'({"operations" if t_ops >= t_bytes else "bytes"}); kernel '
          f'{rec[64][0] + rec[80][0]:.4f} ms = '
          f'{bound_ms / (rec[64][0] + rec[80][0]):.3f} of the bound',
          flush=True)
    return {'name': 'fused_encode_mlp_pts', 'route': 'cuda',
            'source': 'anerf_torch/kernels/csrc/fused_render.cu',
            'replaces': 'anerf_tpu/kernels/fused_render.py:677',
            'launches': None, 'max_abs_err': max_abs,
            'ms': rec[64][0] + rec[80][0],
            'plain_ms': rec[64][1] + rec[80][1],
            'bound_ms': bound_ms,
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'library_ms': None,
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


def profile_phase(torch, np, args, cfg, params, src):
    """With --profile: the second request once more under torch.profiler;
    prints the device-busy share of the wall time and the kernels that
    take the device time."""
    from torch.profiler import ProfilerActivity, profile

    data = _requests(np, src)[1][1]()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, dt = _render(torch, args, cfg, params, data)
    from torch.autograd import DeviceType
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
    print(f'profile "{_requests(np, src)[1][0]}" (under the profiler): '
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
    path, log = fr.build_library()
    print(f'built {path.name} in {time.perf_counter() - t0:.1f} s', flush=True)
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}', flush=True)

    args, cfg, params, src = _flagship(torch, np)
    k1 = kernel_phase(torch, np, cfg, params, src)
    reference_check(torch, np, cfg, params, src)
    k1['launches'] = slice_phase(torch, np, args, cfg, params, src,
                                 k1['ms'])
    if '--profile' in argv:
        profile_phase(torch, np, args, cfg, params, src)

    print(json.dumps({'kernels': [k1]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
