"""The benchmark's own inputs, made from the seed: the skeleton, the
networks' weights (on the device, in a few large calls), the training
batches and the render requests. Both the program and the reference are
handed these same inputs."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .counts import net_of
from .reference import anerf as ref


def seed64(seed: int) -> int:
    """The run's seed as a non-negative 63-bit integer (torch's and
    numpy's generators take any such)."""
    return int(seed) & (2 ** 63 - 1)


def skeleton(n_frames: int) -> Dict[str, np.ndarray]:
    """The synthetic skeleton of `n_frames` frames: the SMPL rest pose x
    0.3, bones and pelvis drawn from default_rng(0) (the same for every
    seed, so every seed renders the same boxes), kp3d and skts by FK."""
    rng = np.random.default_rng(0)
    rest = (ref.SMPL_REST * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n_frames, 24, 3)) * 0.2).astype(np.float32)
    pelvis = (rng.normal(size=(n_frames, 3)) * 0.2).astype(np.float32)
    with torch.no_grad():
        kp3d, skts, _ = ref.fk(torch.as_tensor(bones), torch.as_tensor(rest),
                               torch.as_tensor(pelvis))
    return {'rest': rest, 'bones': bones, 'pelvis': pelvis,
            'kp3d': kp3d.numpy(), 'skts': skts.numpy()}


def _net_shapes(cfg: dict, n_frames: int) -> List[Tuple[str, tuple, float]]:
    """[(leaf path, shape, init scale)] of one network: uniform
    +-1/sqrt(fan_in) weights and biases (torch's nn.Linear default), the
    framecodes xavier-normal (scale < 0 marks a normal draw)."""
    n = net_of(cfg)
    W = n.width
    out = []

    def lin(name, k, m):
        b = 1.0 / np.sqrt(k)
        out.extend([(f'{name}/w', (k, m), b), (f'{name}/b', (m,), b)])
    k = n.dnet_input
    for i in range(n.depth):
        lin(f'pts_linears/{i}', k, W)
        k = W + n.dnet_input if i in n.skips else W
    lin('alpha_linear', W, 1)
    lin('feature_linear', W, W)
    lin('views_linears/0', n.vnet_input, W // 2)
    lin('rgb_linear', W // 2, 3)
    if n.fc:
        std = np.sqrt(2.0 / (n_frames + n.fc))
        out.append(('framecodes/codes', (n_frames, n.fc), -std))
    return out


def _set(tree: dict, path: str, value):
    keys = path.split('/')
    for k, nk in zip(keys[:-1], keys[1:]):
        default = [] if nk.isdigit() else {}
        if isinstance(tree, list):
            k = int(k)
            while len(tree) <= k:
                tree.append(default.copy())
            tree = tree[k]
        else:
            tree = tree.setdefault(k, default)
    if isinstance(tree, list):
        tree.append(value)
    else:
        tree[keys[-1]] = value


def weights(cfg: dict, n_frames: int, seed: int, device,
            lift_density: float = 2.0) -> Dict[str, Any]:
    """{'coarse', 'fine' (None with one network), 'cutoff_dist'} drawn on
    `device` from a generator there seeded with `seed`: one uniform and
    one normal draw for all leaves. The density head's bias is lifted by
    `lift_density`, so that images and losses are not vacuous."""
    t = cfg['train_config']
    nets = ['coarse'] + ([] if t.get('single_net') or not t['N_importance']
                         else ['fine'])
    shapes = _net_shapes(cfg, n_frames)
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    n_u = sum(int(np.prod(s)) for _, s, b in shapes if b > 0) * len(nets)
    n_n = sum(int(np.prod(s)) for _, s, b in shapes if b < 0) * len(nets)
    u = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    z = torch.randn(n_n, generator=gen, device=device)
    pu = pn = 0
    out: Dict[str, Any] = {'fine': None}
    for name in nets:
        tree: Dict[str, Any] = {}
        for path, shape, b in shapes:
            k = int(np.prod(shape))
            if b > 0:
                leaf = u[pu:pu + k].reshape(shape) * b
                pu += k
            else:
                leaf = z[pn:pn + k].reshape(shape) * -b
                pn += k
            _set(tree, path, leaf.clone())
        tree['alpha_linear']['b'] += lift_density
        out[name] = tree
    out['cutoff_dist'] = torch.full((24,), t['cutoff_mm'] * t['ext_scale'],
                                    dtype=torch.float32, device=device)
    return out


def clone_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def train_batches(sk: Dict[str, np.ndarray], cyls: np.ndarray, n: int,
                  unroll: int, n_rays: int, n_images: int, offset,
                  sigma: float, seed: int) -> List[Dict[str, np.ndarray]]:
    """`n` dispatches of `unroll` batches, every batch a new draw: n_images
    distinct frames, n_rays / n_images rays each from a camera at
    root + offset towards targets within `sigma` of the root, uniform
    targets. Dispatch k draws from its own generator (seed, k), so it is
    the same whatever the pool's size. A dispatch's leaves are stacked
    (unroll, ...); index arrays int64."""
    return [_dispatch_batches(sk, cyls, unroll, n_rays, n_images, offset,
                              sigma, np.random.default_rng([seed64(seed), k]))
            for k in range(n)]


def _dispatch_batches(sk, cyls, unroll, n_rays, n_images, offset, sigma,
                      rng) -> Dict[str, np.ndarray]:
    n_frames = sk['kp3d'].shape[0]
    kp_idxs = np.argsort(rng.random((unroll, n_frames)), axis=1)[
        :, :n_images]
    per = n_rays // n_images
    pose_idx = np.repeat(np.arange(n_images), per)
    roots = sk['kp3d'][kp_idxs][:, :, 0]                     # (U, NI, 3)
    o = (roots + np.asarray(offset, np.float32))[:, pose_idx]
    tg = roots[:, pose_idx] + rng.normal(
        size=(unroll, n_rays, 3)).astype(np.float32) * sigma
    d = tg - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.zeros((unroll, n_rays, 1), np.float32)
    return {
        'rays': np.concatenate([o, d, z, z + 1.0, vd], -1).astype(
            np.float32),
        'target_s': rng.uniform(size=(unroll, n_rays, 3)).astype(
            np.float32),
        'fgs': np.ones((unroll, n_rays, 1), np.float32),
        'bgs': np.ones((unroll, n_rays, 3), np.float32),
        'cam_idxs': kp_idxs[:, pose_idx].astype(np.int64),
        'pose_idx': np.broadcast_to(pose_idx.astype(np.int64),
                                    (unroll, n_rays)).copy(),
        'kp_idxs': kp_idxs.astype(np.int64),
        'kp3d': sk['kp3d'][kp_idxs],
        'bones': sk['bones'][kp_idxs],
        'skts': sk['skts'][kp_idxs],
        'cyls': cyls[kp_idxs],
    }


def dispatch(pool: List[Dict[str, np.ndarray]], i: int
             ) -> Dict[str, np.ndarray]:
    """The i-th dispatch's stacked batch of a pool (it wraps)."""
    return pool[i % len(pool)]


def rotate_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def request_camera(sk: Dict[str, np.ndarray], frame: int, angle: float,
                   offset) -> np.ndarray:
    """The c2w of a bullet-time view of `frame`: the camera at
    root + offset, turned by `angle` about the vertical through the
    root."""
    root = sk['kp3d'][frame, 0]
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = root + np.asarray(offset, np.float32)
    shift, unshift = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    shift[:3, 3], unshift[:3, 3] = -root, root
    return (unshift @ rotate_y(angle) @ shift @ c2w).astype(np.float32)


def request_set(traffic: dict) -> List[Tuple[int, float]]:
    """The mix's fixed set of (frame, angle) requests: angle k of
    `n_views` evenly spaced on the orbit, with frame k mod len(frames)."""
    n, frames = traffic['n_views'], traffic['frames']
    return [(frames[k % len(frames)], 2.0 * np.pi * k / n) for k in range(n)]


def box_rays(sk, frame: int, c2w: np.ndarray, H: int, W: int,
             focal: float) -> int:
    """Rays in the box of a request, as the reference draws the box."""
    cyl = ref.kp_cylinder(sk['kp3d'][frame], 0.001, 250, 1.60, 1.10, '-y')
    tl, br = ref.cylinder_box(cyl, H, W, focal, c2w)
    return int((br[0] - tl[0]) * (br[1] - tl[1]))
