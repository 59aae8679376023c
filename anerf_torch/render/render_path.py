"""Full-image rendering: cylinder-culled box rays, fixed-size buckets,
canvas compositing (torch port of anerf_tpu/render/render_path.py).

Per pose, the box of the projected bounding cylinder is enumerated
row-major into rays on the device, and the rays go through render_rays in
buckets of `chunk`. The last bucket is filled with the rays that continue
past the box, as in the JAX package, so every bucket holds the same rays
there and here (the near/far fill for rays that miss the cylinder is a
per-bucket mean). The JAX package also pads the bucket COUNT to a power
of two to bound recompiles; eager PyTorch has none, so the port renders
ceil(n / chunk) buckets.

Data parallel (`mesh=`, parallel/mesh.py): `chunk` is padded to a
multiple of the mesh size, as in JAX; every rank builds each bucket's
rays and their near/far (the fill for rays that miss the cylinder is a
mean over the whole bucket, which JAX's partitioner also takes over the
sharded bucket), renders its contiguous block of the bucket, and the
blocks are gathered, so every rank ends with the whole image.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops.cylinder import cylinder_to_box_2d, get_kp_bounding_cylinder
from ..ops.rays import nerf_c2w_to_extrinsic
from ..parallel.mesh import all_gather_rows, pad_to_multiple
from .raycaster import (RenderConfig, pack_fused_params, ray_near_far,
                        render_rays)

OUT_KEYS = ('rgb_map', 'disp_map', 'acc_map')


def make_render_fn(cfg: RenderConfig, params: Dict[str, Any],
                   use_framecode_idx: bool, mesh=None) -> Callable:
    """A renderer for one pose: (scal, tables, n_buckets, chunk) ->
    {'rgb_map', 'disp_map', 'acc_map'} over n_buckets * chunk box rays.

    scal is the 26-float vector of pack_pose_scalars; tables hold the
    stacked pose tables on the device. The kernel operands are packed
    once here, not per bucket, and the buckets render without autograd.
    With a data-parallel `mesh` (chunk a multiple of its size) each rank
    renders its block of every bucket and every rank returns them all.
    """
    test_cfg = cfg.test_mode()
    with torch.no_grad():
        packed = (pack_fused_params(params, test_cfg) if cfg.use_fused
                  else None)

    @torch.no_grad()
    def fn(scal: np.ndarray, tables: Dict[str, Optional[torch.Tensor]],
           n_buckets: int, chunk: int) -> Dict[str, torch.Tensor]:
        scal = np.asarray(scal, np.float32)
        dev = tables['kp3d'].device
        c2w = torch.as_tensor(scal[:16].reshape(4, 4), device=dev)
        fx, fy, ox, oy, tl_x, tl_y = (float(x) for x in scal[16:22])
        box_w = int(scal[22])
        pose_idx, cam_idx = int(scal[23]), int(scal[24])
        tau = float(scal[25])

        def per_ray(t):
            return t[pose_idx].expand((chunk,) + t.shape[1:])

        kp3d, skts, cyls = (per_ray(tables[k])
                            for k in ('kp3d', 'skts', 'cyls'))
        bones = None if tables['bones'] is None else per_ray(tables['bones'])
        cam_idxs = torch.full((chunk,), cam_idx, dtype=torch.long,
                              device=dev)

        R = n_buckets * chunk
        k = torch.arange(R, device=dev)
        py = tl_y + torch.div(k, box_w, rounding_mode='floor').float()
        px = tl_x + (k % box_w).float()
        dirs = torch.stack([(px - ox) / fx, -(py - oy) / fy,
                            -torch.ones_like(px)], -1)
        rays_d = (dirs[:, None, :] * c2w[:3, :3]).sum(-1)   # dirs @ R^T
        rays_o = c2w[:3, 3].expand(R, 3)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        zeros = torch.zeros((R, 1), dtype=torch.float32, device=dev)
        rays = torch.cat([rays_o, rays_d, zeros, zeros + 1.0, viewdirs], -1)

        blk = slice(None) if mesh is None else mesh.block(chunk)
        blocked = lambda t: None if t is None else t[blk]
        outs = []
        for b in range(n_buckets):
            rays_b = rays[b * chunk:(b + 1) * chunk]
            near_far = None
            if mesh is not None:
                near_far = tuple(x[blk] for x in ray_near_far(rays_b, cyls))
            ret = render_rays(
                params, test_cfg, rays_b[blk], blocked(kp3d),
                blocked(skts), blocked(bones), blocked(cyls),
                cam_idxs=blocked(cam_idxs) if use_framecode_idx else None,
                tau=tau, eval_framecode_mean=not use_framecode_idx,
                packed=packed, near_far=near_far)
            outs.append(torch.cat([ret['rgb_map'], ret['disp_map'][:, None],
                                   ret['acc_map'][:, None]], -1))
        out = torch.stack(outs)                       # (buckets, rays, 5)
        if mesh is not None:
            # rank r's rows are rays [r * m, (r + 1) * m) of every bucket
            out = all_gather_rows(mesh, out.transpose(0, 1)).transpose(0, 1)
        out = out.reshape(n_buckets * chunk, 5)
        return {'rgb_map': out[:, :3], 'disp_map': out[:, 3],
                'acc_map': out[:, 4]}
    return fn


def pack_pose_scalars(c2w, focal, center, tl, br, pose_idx: int,
                      cam_idx: Optional[int], tau: float) -> np.ndarray:
    """One pose's camera + box + indices as the 26-float vector
    [c2w(16) | fx fy | ox oy | tl_x tl_y | box_w | pose_idx | cam_idx |
    tau] that make_render_fn unpacks."""
    f = np.asarray(focal, np.float32).reshape(-1)
    fx = float(f[0])
    fy = float(f[1]) if f.size > 1 else fx
    bw = max(int(br[0] - tl[0]), 1)
    return np.concatenate([
        np.asarray(c2w, np.float32).reshape(-1)[:16],
        np.asarray([fx, fy, float(center[0]), float(center[1]),
                    float(tl[0]), float(tl[1]), float(bw),
                    float(pose_idx), float(cam_idx or 0), float(tau)],
                   np.float32)])


def n_buckets_for(n: int, chunk: int) -> int:
    """Buckets of `chunk` rays that cover n box rays."""
    return max(1, -(-n // chunk))


def render_one_pose(render_fn, tables, scal: np.ndarray, n: int,
                    chunk: int = 4096) -> Dict[str, np.ndarray]:
    """Render one pose; returns per-box-pixel (row-major) numpy outputs
    of length n."""
    ret = render_fn(scal, tables, n_buckets_for(n, chunk), chunk)
    return {k: ret[k][:n].cpu().numpy() for k in OUT_KEYS}


def render_path(params, cfg: RenderConfig,
                c2ws: np.ndarray, hwf, kps: np.ndarray, skts: np.ndarray,
                bones: Optional[np.ndarray],
                cam_idxs: Optional[np.ndarray] = None,
                centers: Optional[np.ndarray] = None,
                cyls: Optional[np.ndarray] = None,
                bgs: Optional[np.ndarray] = None,
                bg_idxs: Optional[np.ndarray] = None,
                tau: float = 2000.0,
                chunk: int = 4096,
                render_factor: int = 0,
                ext_scale: float = 0.001,
                white_bkgd: bool = True,
                use_framecode_idx: bool = False,
                mesh=None,
                verbose: bool = False) -> Dict[str, np.ndarray]:
    """Render a sequence of poses/cameras into full images, on the device
    that holds `params`.

    hwf: (H, W, focals) with H/W scalars or per-frame arrays.
    mesh: a data-parallel DataMesh (every rank calls render_path with the
    same arguments and gets the whole result; make_render_fn).
    Returns 'rgbs', 'disps', 'accs', 'bboxes' stacked (N, H, W, .).
    """
    H_all, W_all, focals = hwf
    n_poses = len(c2ws)
    dev = params['cutoff_dist'].device
    if mesh is not None:
        # each bucket's ray axis splits over the mesh
        chunk = pad_to_multiple(chunk, mesh.size)

    if cyls is None:
        cyls = get_kp_bounding_cylinder(
            kps, ext_scale=ext_scale, extend_mm=250,
            top_expand_ratio=1.60, bot_expand_ratio=1.10, head='-y')

    render_fn = make_render_fn(cfg, params, use_framecode_idx, mesh)

    def put(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=dev)

    tables = {'kp3d': put(kps), 'skts': put(skts), 'bones': put(bones),
              'cyls': put(cyls)}

    rgbs, disps, accs, bboxes = [], [], [], []
    t0 = time.time()
    for i in range(n_poses):
        H = int(H_all if np.isscalar(H_all) else np.asarray(H_all).reshape(-1)[
            i % np.asarray(H_all).size])
        W = int(W_all if np.isscalar(W_all) else np.asarray(W_all).reshape(-1)[
            i % np.asarray(W_all).size])
        focal = (float(focals) if np.isscalar(focals)
                 else np.asarray(focals).reshape(-1)[i % np.asarray(
                     focals).size])
        if render_factor > 0:
            H, W, focal = H // render_factor, W // render_factor, \
                focal / render_factor

        pose_i = i % len(kps)
        c2w = np.asarray(c2ws[i], np.float32)
        center = None if centers is None else centers[i]

        w2c = nerf_c2w_to_extrinsic(c2w)
        tl, br, _ = cylinder_to_box_2d(cyls[pose_i], [H, W, focal], w2c,
                                       center=center)
        hh, ww = np.meshgrid(np.arange(tl[1], br[1]),
                             np.arange(tl[0], br[0]), indexing='ij')
        valid_idx = (hh * W + ww).reshape(-1)

        offset = (center if center is not None
                  else np.array([W * 0.5, H * 0.5], np.float32))
        n = len(valid_idx)
        if n == 0:
            out = {'rgb_map': np.zeros((0, 3), np.float32),
                   'disp_map': np.zeros((0,), np.float32),
                   'acc_map': np.zeros((0,), np.float32)}
        else:
            scal = pack_pose_scalars(
                c2w, focal, offset, tl, br, pose_i,
                None if cam_idxs is None
                else int(cam_idxs[i % len(cam_idxs)]), tau)
            out = render_one_pose(render_fn, tables, scal, n, chunk)

        if bgs is not None and bg_idxs is not None:
            canvas = np.asarray(bgs[bg_idxs[i % len(bg_idxs)]],
                                np.float32).copy()
            if render_factor > 0:
                import cv2
                canvas = cv2.resize(canvas, (W, H))
        elif white_bkgd:
            canvas = np.ones((H, W, 3), np.float32)
        else:
            canvas = np.zeros((H, W, 3), np.float32)

        canvas = canvas.reshape(-1, 3)
        acc = out['acc_map'][..., None]
        canvas[valid_idx] = (out['rgb_map'] * acc
                             + canvas[valid_idx] * (1.0 - acc))
        rgbs.append(canvas.reshape(H, W, 3))

        disp = np.zeros((H * W,), np.float32)
        disp[valid_idx] = np.nan_to_num(out['disp_map'])
        disps.append(disp.reshape(H, W))

        acc_img = np.zeros((H * W,), np.float32)
        acc_img[valid_idx] = out['acc_map']
        accs.append(acc_img.reshape(H, W))
        bboxes.append(np.stack([tl, br]))
        if verbose:
            print(f'pose {i}: +{time.time() - t0:.2f}s ({n} rays)')

    return {'rgbs': np.stack(rgbs), 'disps': np.stack(disps),
            'accs': np.stack(accs), 'bboxes': np.stack(bboxes)}
