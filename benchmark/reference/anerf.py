"""The plain reference of A-NeRF's render and train step, in float32.

A frozen, independent copy of the arithmetic that the program under test
runs (the skeleton-relative encoding with cutoff windows, the MLP, volume
compositing, importance resampling, forward kinematics of refined poses,
the losses and both Adams), written in plain PyTorch and NumPy for the
flagship family of encoders only: reldist / reldir / relray, cutoff PE on
the inputs and the view directions. It imports nothing of the program.
Every matrix product is a float32 one with TF32 off (`strict_f32`).

`lowp=True` rounds both operands of every MLP product to fp8 (e4m3, one
scale per tensor): the control, a precision below the bfloat16 that the
configurations state, put in the program's place.

Randomness: stratified jitter, density noise and importance draws come
from a torch.Generator in the program's order and shapes, so a generator
in the same state hands both sides the same draws.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# --------------------------------------------------------------- skeleton

#: SMPL's parent table (the root points at itself)
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
           17, 18, 19, 20, 21)
N_JOINTS = 24
ROOT = 0

#: the canonical SMPL rest pose (joint locations, metres)
SMPL_REST = np.array(
    [[0.00000000e+00, 2.30003661e-09, -9.86228770e-08],
     [1.63832515e-01, -2.17391014e-01, -2.89178602e-02],
     [-1.57855421e-01, -2.14761734e-01, -2.09642015e-02],
     [-7.04505108e-03, 2.50450850e-01, -4.11837511e-02],
     [2.42021069e-01, -1.08830070e+00, -3.14962119e-02],
     [-2.47206554e-01, -1.10715497e+00, -3.06970738e-02],
     [3.95125849e-03, 5.94849110e-01, -4.03754264e-02],
     [2.12680623e-01, -1.99382353e+00, -1.29327580e-01],
     [-2.10857525e-01, -2.01218796e+00, -1.23002514e-01],
     [9.39484313e-03, 7.19204426e-01, 2.06931755e-02],
     [2.63385147e-01, -2.12222481e+00, 1.46775618e-01],
     [-2.51970559e-01, -2.12153077e+00, 1.60450473e-01],
     [3.83779174e-03, 1.22592449e+00, -9.78838727e-02],
     [1.91201791e-01, 1.00385976e+00, -6.21964522e-02],
     [-1.77145526e-01, 9.96228695e-01, -7.55542740e-02],
     [1.68482102e-02, 1.38698268e+00, 2.44048554e-02],
     [4.01985168e-01, 1.07928419e+00, -7.47655183e-02],
     [-3.98825467e-01, 1.07523870e+00, -9.96334553e-02],
     [1.00236952e+00, 1.05217218e+00, -1.35129794e-01],
     [-9.86728609e-01, 1.04515052e+00, -1.40235111e-01],
     [1.56646240e+00, 1.06961894e+00, -1.37338534e-01],
     [-1.56946480e+00, 1.05935931e+00, -1.53905824e-01],
     [1.75282109e+00, 1.04682994e+00, -1.68231070e-01],
     [-1.75758195e+00, 1.04255080e+00, -1.77773550e-01]], np.float32)


def _levels() -> List[List[int]]:
    depth = [0] * N_JOINTS
    for j in range(1, N_JOINTS):
        depth[j] = depth[PARENTS[j]] + 1
    return [[j for j in range(N_JOINTS) if depth[j] == d]
            for d in range(max(depth) + 1)]


LEVELS = _levels()


def strict_f32() -> None:
    """float32 products on the card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -------------------------------------------------------------- rotations

def axisang_to_rot(a: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, with its Taylor terms near a zero angle."""
    t2 = (a * a).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp_min(t2, 1e-30))
    small = t2 < 1e-8
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp_min(t2, 1e-30))
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    o = torch.zeros_like(x)
    k = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], -2)
    kk = (k[..., :, :, None] * k[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    return eye + s[..., None] * k + c[..., None] * kk


def rot6d_to_rot(x: torch.Tensor) -> torch.Tensor:
    """The first two columns, Gram-Schmidt, and their cross product."""
    x = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True),
                              1e-12)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / torch.clamp_min(torch.linalg.norm(u, dim=-1, keepdim=True),
                             1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1)


def rot_to_rot6d(r: torch.Tensor) -> torch.Tensor:
    return r[..., :3, :2].reshape(*r.shape[:-2], 6)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def fk(bones: torch.Tensor, rest: torch.Tensor, pelvis: torch.Tensor):
    """Forward kinematics: bones (N, 24, 3|6), rest (24, 3), pelvis (N, 3)
    -> kp3d (N, 24, 3), skts (N, 24, 4, 4) world-to-joint, rots."""
    n = bones.shape[0]
    rots = axisang_to_rot(bones) if bones.shape[-1] == 3 \
        else rot6d_to_rot(bones)
    rest = rest.reshape(1, N_JOINTS, 3).expand(n, N_JOINTS, 3)
    offs = (rest - rest[:, list(PARENTS)]).clone()
    offs[:, ROOT] = rest[:, ROOT]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=bones.dtype,
                          device=bones.device)
    rel = torch.cat([torch.cat([rots, offs[..., None]], -1),
                     bottom.expand(n, N_JOINTS, 1, 4)], -2)
    l2w = torch.zeros((n, N_JOINTS, 4, 4), dtype=bones.dtype,
                      device=bones.device)
    l2w[:, ROOT] = rel[:, ROOT]
    for level in LEVELS[1:]:
        l2w[:, level] = _mm(l2w[:, [PARENTS[j] for j in level]], rel[:, level])
    l2w = l2w.clone()
    l2w[..., :3, 3] = l2w[..., :3, 3] + pelvis[:, None, :]
    rt = l2w[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rt, -_mm(rt, l2w[..., :3, 3:])], -1)
    skts = torch.cat([top, bottom.expand(n, N_JOINTS, 1, 4)], -2)
    return l2w[..., :3, 3], skts, rots


# --------------------------------------------------------------- cylinder

def kp_cylinder(kp: np.ndarray, ext_scale: float, extend_mm: float,
                top_ratio: float, bot_ratio: float, head: str) -> np.ndarray:
    """(..., 5) = (cx, cz, radius, top, bottom) around the joints."""
    g, h = ([0, 1], 2) if head.endswith('z') else ([0, 2], 1)
    flip = -1 if head.startswith('-') else 1
    root = kp[..., ROOT, :]
    dist = np.linalg.norm(kp[..., g] - root[..., None, g], axis=-1)
    ext = extend_mm * ext_scale
    top = flip * ((flip * kp[..., h]).max(-1) + ext * top_ratio)
    bot = flip * ((flip * kp[..., h]).min(-1) - ext * bot_ratio)
    return np.stack([root[..., g[0]], root[..., g[1]], dist.max(-1) + ext,
                     top, bot], -1).astype(np.float32)


def cylinder_box(cyl: np.ndarray, H: int, W: int, focal: float,
                 c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The integer image box (tl, br) of a cylinder's projection: 50
    points on each cap through the camera, rounded outwards, clipped."""
    swap = np.concatenate([c2w[:, 0:1], -c2w[:, 1:2], -c2w[:, 2:3],
                           c2w[:, 3:]], -1)
    w2c = np.linalg.inv(swap)
    rads = np.linspace(0.0, 2 * np.pi, 50)
    x = cyl[0] + np.cos(rads) * cyl[2]
    z = cyl[1] + np.sin(rads) * cyl[2]
    one = np.ones_like(x)
    caps = np.concatenate([np.stack([x, cyl[3] * one, z, one], -1),
                           np.stack([x, cyl[4] * one, z, one], -1)], 0)
    k = np.array([[focal, 0, 0, 0], [0, focal, 0, 0], [0, 0, 1, 0]],
                 np.float32)
    p = (caps @ w2c.T) @ k.T
    p2 = p[:, :2] / p[:, 2:3]
    tl = np.array([np.floor(p2[:, 0].min()), np.floor(p2[:, 1].min())],
                  np.int32) + np.array([int(W * 0.5), int(H * 0.5)], np.int32)
    br = np.array([np.ceil(p2[:, 0].max()), np.ceil(p2[:, 1].max())],
                  np.int32) + np.array([int(W * 0.5), int(H * 0.5)], np.int32)
    tl = np.array([np.clip(tl[0], 0, W - 1), np.clip(tl[1], 0, H - 1)])
    br = np.array([np.clip(br[0], 0, W - 1), np.clip(br[1], 0, H - 1)])
    return tl, br


def near_far(rays_o: torch.Tensor, rays_d: torch.Tensor, cyl: torch.Tensor,
             near: torch.Tensor, far: torch.Tensor):
    """Where each ray enters and leaves the cylinder's circle on the
    ground plane (x, z); rays that miss take the mean of the hits."""
    g = [0, 2]
    r_near = (rays_o + rays_d * near)[..., g]
    r_far = (rays_o + rays_d * far)[..., g]
    nc = cyl[..., :2] - r_near
    nf = r_far - r_near
    nf_norm = torch.linalg.norm(nf, dim=-1)
    scale = torch.clamp_min(torch.linalg.norm(rays_d[..., g], dim=-1,
                                              keepdim=True), 1e-12)
    cross = nc[..., 0] * nf[..., 1] - nc[..., 1] * nf[..., 0]
    dist = (cross.abs() / torch.clamp_min(nf_norm, 1e-12))[..., None]
    q2 = cyl[..., 2:3] ** 2 - dist ** 2
    hits = q2 >= 0.0
    q = torch.sqrt(torch.clamp_min(q2, 0.0))
    k = ((nc * nf).sum(-1) / torch.clamp_min(nf_norm, 1e-12))[..., None]
    inside = (q >= k).to(rays_o.dtype)
    n_near = near + (1.0 - inside) * (k - q) / scale
    n_far = near + (k + q) / scale
    n_hit = torch.clamp_min(hits.sum(), 1)
    m_near = torch.where(hits, n_near, 0.0).sum() / n_hit
    m_far = torch.where(hits, n_far, 0.0).sum() / n_hit
    anyh = hits.any()
    return (torch.where(hits, n_near, torch.where(anyh, m_near, near)),
            torch.where(hits, n_far, torch.where(anyh, m_far, far)))


# --------------------------------------------------------------- sampling

def stratified(near, far, n, perturb, gen):
    t = torch.linspace(0.0, 1.0, n, dtype=near.dtype, device=near.device)
    z = near * (1.0 - t) + far * t
    if perturb > 0.0:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        u = torch.rand(z.shape, generator=gen, dtype=z.dtype, device=z.device)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(bins, weights, n, det, gen):
    """Inverse-CDF samples of the piecewise-constant pdf `weights` over
    the intervals between `bins`."""
    w = weights.detach() + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n,)
    if det:
        u = torch.linspace(0.0, 1.0, n, dtype=cdf.dtype,
                           device=cdf.device).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=gen, dtype=cdf.dtype,
                       device=cdf.device)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = torch.clamp_min(inds - 1, 0)
    hi = torch.clamp_max(inds, cdf.shape[-1] - 1)
    pad = cdf.shape[-1] - bins.shape[-1]
    if pad:
        bins = torch.cat([bins, bins[..., -1:].expand(*bins.shape[:-1], pad)],
                         -1)
    c_lo, c_hi = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    b_lo, b_hi = torch.gather(bins, -1, lo), torch.gather(bins, -1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def importance(z, weights, n, det, is_only, gen):
    """New samples where the coarse weights are; returns the merged,
    sorted z, the new samples, and each merged sample's rank."""
    mid = 0.5 * (z[..., 1:] + z[..., :-1])
    if is_only:
        w_l, w_k, w_u = weights[..., :-2], weights[..., 1:-1], weights[..., 2:]
        dw = 0.5 * (torch.maximum(w_l, w_k) + torch.maximum(w_k, w_u)) + 0.01
    else:
        dw = weights[..., 1:-1]
    zs = sample_pdf(mid, dw, n, det, gen).detach()
    zc = torch.cat([z, zs], -1)
    order = torch.sort(zc, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(zc.shape[-1], device=z.device).expand_as(order))
    return _scatter(zc, ranks), zs, ranks


def _scatter(x, ranks):
    idx = ranks.reshape(ranks.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.empty_like(x).scatter_(1, idx, x)


def composite(raw, z, rays_d, noise_std, gen, rgb_eps=1e-3):
    """Alpha compositing of raw (R, S, 4) = [rgb logits, density]."""
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3]) * (1 + 2 * rgb_eps) - rgb_eps
    sigma = raw[..., 3]
    if noise_std > 0.0:
        sigma = sigma + torch.randn(sigma.shape, generator=gen,
                                    dtype=sigma.dtype,
                                    device=sigma.device) * noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    rgb_map = (w[..., None] * rgb).sum(-2)
    depth = (w * z).sum(-1)
    wsum = w.sum(-1)
    disp = 1.0 / torch.clamp_min(depth / (wsum + 1e-10), 1e-10)
    disp = torch.where(torch.isclose(wsum, torch.zeros_like(wsum)), 0.0, disp)
    return {'rgb': rgb_map, 'disp': disp, 'acc': torch.clamp_max(wsum, 1.0),
            'weights': w}


# --------------------------------------------------------------- encoding

def _cutoff_pe(x, nf, w):
    """[x, sin 2^0 x, cos 2^0 x, ..., cos 2^(nf-1) x] rows, each times
    the window w (..., 1, D), flattened row-major (..., (1 + 2 nf) D)."""
    fb = torch.as_tensor(2.0 ** np.linspace(0.0, nf - 1, nf), dtype=x.dtype,
                         device=x.device) if nf else None
    rows = [x[..., None, :]]
    if nf:
        arg = fb[:, None] * x[..., None, :]
        sc = torch.stack([torch.sin(arg), torch.cos(arg)], -2)
        rows.append(sc.reshape(*sc.shape[:-3], 2 * nf, sc.shape[-1]))
    shape = torch.broadcast_shapes(x[..., None, :].shape[:-2], w.shape[:-2])
    rows = torch.cat([r.expand(*shape, *r.shape[-2:]) for r in rows], -2)
    out = rows * w
    return out.reshape(*out.shape[:-2], -1)


def encode(pts, rays_d, skts, cutoff, tau, nfk, nfv):
    """Skeleton-relative inputs: pts (R, S, 3), rays_d (R, 3), skts
    (R, 24, 4, 4), cutoff (24,) -> (x_pts (R, S, 24 (1 + 2 nfk) + 72),
    x_view (R, S, 72 (1 + 2 nfv)))."""
    rot, trans = skts[:, :, :3, :3], skts[:, :, :3, 3]
    p = (rot[:, None] * pts[:, :, None, None, :]).sum(-1) + trans[:, None]
    v = torch.sqrt(torch.clamp_min((p * p).sum(-1), 0.0))        # (R, S, J)
    r = p / torch.clamp_min(v, 1e-12)[..., None]
    rr = (rot * rays_d[:, None, None, :]).sum(-1)                 # (R, J, 3)
    d = rr * torch.rsqrt(torch.clamp_min((rr * rr).sum(-1), 1e-24))[..., None]
    w = 1.0 - torch.sigmoid(tau * (v - cutoff))                  # (R, S, J)
    x_kp = _cutoff_pe(v, nfk, w[..., None, :])
    wv = w.repeat_interleave(3, -1)[..., None, :]                 # (R, S, 1, 72)
    x_view = _cutoff_pe(d.reshape(d.shape[0], 1, -1), nfv, wv)
    R, S = pts.shape[:2]
    return (torch.cat([x_kp, r.reshape(R, S, -1)], -1), x_view)


# -------------------------------------------------------------------- MLP

class _Fp8(torch.autograd.Function):
    """Round to fp8 e4m3 with one scale per tensor; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        s = 448.0 / torch.clamp_min(x.detach().abs().max(), 1e-30)
        return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


def _dense(p, x, lowp):
    w = p['w']
    if lowp:
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    return x @ w + p['b']


def mlp(net, x_pts, x_view, fc, skips, lowp=False):
    """raw (..., 4) = [rgb logits, density] of the A-NeRF MLP."""
    h = x_pts
    for i, layer in enumerate(net['pts_linears']):
        h = torch.relu(_dense(layer, h, lowp))
        if i in skips:
            h = torch.cat([x_pts, h], -1)
    alpha = _dense(net['alpha_linear'], h, lowp)
    feat = _dense(net['feature_linear'], h, lowp)
    views = x_view if fc is None else torch.cat([x_view, fc], -1)
    hv = torch.cat([feat, views], -1)
    for layer in net['views_linears']:
        hv = torch.relu(_dense(layer, hv, lowp))
    return torch.cat([_dense(net['rgb_linear'], hv, lowp), alpha], -1)


# ------------------------------------------------------------ render rays

def render_rays(nets, model, rays, cyl, skts, fc_idx, tau, gen,
                perturb, noise_std, lowp=False, near_far_given=None):
    """Both passes over rays (R, 11) = [o, d, near, far, viewdirs] with
    per-ray cylinders (R, 5), skts (R, 24, 4, 4) and framecode rows
    fc_idx (R,) (None: the mean code). `model` holds n_samples,
    n_importance, single_net, nfk, nfv, skips. Returns the fine and the
    coarse maps."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    if near_far_given is None:
        near, far = near_far(o, d, cyl, rays[:, 6:7], rays[:, 7:8])
    else:
        near, far = near_far_given
    z = stratified(near, far, model['n_samples'], perturb, gen)
    pts = o[:, None] + d[:, None] * z[..., None]

    def codes(net):
        c = net['framecodes']['codes']
        if fc_idx is None:
            return c.mean(0, keepdim=True).expand(rays.shape[0], c.shape[-1])
        return c[fc_idx]

    def run(net, p):
        xp, xv = encode(p, d, skts, nets['cutoff_dist'], tau, model['nfk'],
                        model['nfv'])
        fc = codes(net)[:, None].expand(p.shape[0], p.shape[1], -1)
        return mlp(net, xp, xv, fc, model['skips'], lowp)

    coarse = nets['coarse']
    raw = run(coarse, pts)
    c = composite(raw, z, d, noise_std, gen)
    za, zs, ranks = importance(z, c['weights'], model['n_importance'],
                               perturb == 0.0, model['single_net'], gen)
    pts_is = o[:, None] + d[:, None] * zs[..., None]
    if model['single_net']:
        raw_all = torch.cat([raw, run(coarse, pts_is)], 1)
    else:
        raw_all = run(nets['fine'], torch.cat([pts, pts_is], 1))
    f = composite(_scatter(raw_all, ranks), za, d, noise_std, gen)
    return f, c


# ------------------------------------------------------------- train step

def tau_at(step: int) -> float:
    """The cutoff sharpness at a train step: 20 x 10^(step / 250000) in
    float32, at most 2000."""
    f32 = np.float32
    with np.errstate(over='ignore'):
        t = f32(20.0) * f32(10.0) ** (f32(step) / f32(250 * 1000))
    return float(min(t, f32(2000.0)))


def lr_at(lrate, decay, rate, unit, count):
    f32 = np.float32
    return float(f32(lrate) * f32(rate) ** (f32(int(count) // int(unit))
                                            / f32(decay)))


def adam(g, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax's adam on a flat vector: (update, mu, nu)."""
    f32 = np.float32
    mu = (1.0 - b1) * g + b1 * mu
    nu = (1.0 - b2) * (g * g) + b2 * nu
    c1 = float(f32(1.0) - f32(b1) ** (count + 1))
    c2 = float(f32(1.0) - f32(b2) ** (count + 1))
    return -lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)), mu, nu


def tree_items(tree, prefix=''):
    """[(path, tensor)] in sorted-key order (lists in order, None
    skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_items(tree[k], f'{prefix}{k}/')]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_items(v, f'{prefix}{i}/')]
    return [(prefix.rstrip('/'), tree)]


def _unflatten(flat, tree):
    pos = [0]

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        n = t.numel()
        out = flat[pos[0]:pos[0] + n].view(t.shape)
        pos[0] += n
        return out
    return build(tree)


def _flat(tree):
    return torch.cat([t.reshape(-1) for _, t in tree_items(tree)])


class TrainReference:
    """The train step in float32: the state is the network tree, the pose
    tree {'bones' (rot6d), 'pelvis'} and the Adam moments; `step` runs one
    step on a batch of tensors and returns its losses, the flat gradients
    as each Adam gets them (None when the pose Adam does not step) and
    the updates applied. `start` continues from a state part way through
    training: {'mu', 'nu', 'pmu', 'pnu', 'acc'} (flat, in the trees'
    order), 'step' and 'pose_count'; by default every moment is zero."""

    def __init__(self, nets, pose, anchors_rot, rest, model, opt,
                 lowp=False, half_batch=False, start=None):
        self.nets, self.pose, self.model, self.opt = nets, pose, model, opt
        self.anchors_rot, self.rest, self.lowp = anchors_rot, rest, lowp
        self.half_batch = half_batch
        fn = _flat(nets)
        fp = _flat(pose)
        self.mu, self.nu = torch.zeros_like(fn), torch.zeros_like(fn)
        self.pmu, self.pnu = torch.zeros_like(fp), torch.zeros_like(fp)
        self.acc = torch.zeros_like(fp)
        self.step_i, self.pose_count = 0, 0
        if start is not None:
            for k in ('mu', 'nu', 'pmu', 'pnu', 'acc'):
                setattr(self, k, start[k].detach().clone().float())
            self.step_i, self.pose_count = start['step'], start['pose_count']

    def state(self) -> dict:
        """The state as `start` takes it, with both trees flat
        ('nets_flat', 'pose_flat')."""
        return {'nets_flat': _flat(self.nets), 'pose_flat': _flat(self.pose),
                'mu': self.mu, 'nu': self.nu, 'pmu': self.pmu,
                'pnu': self.pnu, 'acc': self.acc, 'step': self.step_i,
                'pose_count': self.pose_count}

    def loss(self, nets, pose, b, gen):
        m = self.model
        kp_idxs, pose_idx = b['kp_idxs'], b['pose_idx']
        bones_i = pose['bones'][kp_idxs]
        kps, skts, rots = fk(bones_i, self.rest, pose['pelvis'][kp_idxs])
        rays, target = b['rays'], b['target_s']
        cyl, bgs = b['cyls'][pose_idx], b['bgs']
        skts_r, cam = skts[pose_idx], b['cam_idxs']
        if self.half_batch:      # a fault: half the rays, the mean of those
            h = rays.shape[0] // 2
            rays, target, cyl, bgs = rays[:h], target[:h], cyl[:h], bgs[:h]
            skts_r, cam = skts_r[:h], cam[:h]
        f, c = render_rays(nets, m, rays, cyl, skts_r, cam,
                           tau_at(self.step_i), gen, 1.0, m['raw_noise_std'],
                           self.lowp)
        out = {}
        for key, r in (('rgb_loss', f), ('rgb_loss0', c)):
            pred = r['rgb'] + (1.0 - r['acc'])[..., None] * bgs
            out[key] = ((pred - target) ** 2).mean()
        kl = ((rot_to_rot6d(self.anchors_rot[kp_idxs])
               - rot_to_rot6d(rots)) ** 2)[:, 1:]
        tol = m['opt_pose_tol']
        kl = torch.where(kl > tol, kl - tol, torch.zeros_like(kl)).sum(-1)
        out['kp_loss'] = kl.mean() * m['opt_pose_coef']
        out['total_loss'] = out['rgb_loss'] + out['rgb_loss0'] \
            + out['kp_loss']
        return out

    def step(self, batch, gen):
        o = self.opt
        fn = _flat(self.nets).detach().requires_grad_(True)
        fp = _flat(self.pose).detach().requires_grad_(True)
        losses = self.loss(_unflatten(fn, self.nets),
                           _unflatten(fp, self.pose), batch, gen)
        gn, gp = torch.autograd.grad(losses['total_loss'], [fn, fp])
        gtree = _unflatten(gn, self.nets)
        gtree['cutoff_dist'].zero_()
        upd, self.mu, self.nu = adam(
            gn, self.mu, self.nu, self.step_i,
            lr_at(o['lrate'], o['lrate_decay'], o['lrate_decay_rate'],
                  o['decay_unit'], self.step_i))
        self.nets = _unflatten(fn.detach() + upd, self.nets)
        pose_g = pose_upd = None
        self.acc = self.acc + gp
        if self.step_i % o['opt_pose_step'] == 0:
            pose_g = self.acc
            pose_upd, self.pmu, self.pnu = adam(
                self.acc, self.pmu, self.pnu, self.pose_count,
                lr_at(o['opt_pose_lrate'], o['opt_pose_lrate_decay'],
                      o['opt_pose_decay_rate'], o['opt_pose_decay_unit'],
                      self.pose_count))
            self.pose = _unflatten(fp.detach() + pose_upd, self.pose)
            self.pose_count += 1
            self.acc = torch.zeros_like(self.acc)
        self.step_i += 1
        return ({k: v.detach() for k, v in losses.items()}, gn.detach(),
                upd.detach(), pose_g, pose_upd)


# ----------------------------------------------------------------- render

def ray_grid(c2w: np.ndarray, focal: float, H: int, W: int,
             tl: np.ndarray, br: np.ndarray, n_rays: int, device):
    """The first `n_rays` rays of the box, row-major from its top left,
    continuing past its bottom row: (n_rays, 11)."""
    bw = max(int(br[0] - tl[0]), 1)
    k = torch.arange(n_rays, device=device)
    py = float(tl[1]) + torch.div(k, bw, rounding_mode='floor').float()
    px = float(tl[0]) + (k % bw).float()
    ox, oy = W * 0.5, H * 0.5
    dirs = torch.stack([(px - ox) / focal, -(py - oy) / focal,
                        -torch.ones_like(px)], -1)
    c = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    d = (dirs[:, None, :] * c[:3, :3]).sum(-1)
    o = c[:3, 3].expand(n_rays, 3)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.zeros((n_rays, 1), dtype=torch.float32, device=device)
    return torch.cat([o, d, z, z + 1.0, vd], -1)


@torch.no_grad()
def render_image(nets, model, kp: np.ndarray, skts: np.ndarray,
                 frame: int, c2w: np.ndarray, H: int, W: int, focal: float,
                 chunk: int, device, lowp=False) -> Dict[str, np.ndarray]:
    """One request: the image's rgb (composited over white), acc and disp
    (H, W), rendering the cylinder's box in buckets of `chunk` rays, as
    the render path defines it."""
    cyl = kp_cylinder(kp, 0.001, 250, 1.60, 1.10, '-y')
    tl, br = cylinder_box(cyl, H, W, focal, c2w)
    hh, ww = np.meshgrid(np.arange(tl[1], br[1]), np.arange(tl[0], br[0]),
                         indexing='ij')
    idx = (hh * W + ww).reshape(-1)
    n = len(idx)
    rgb = np.ones((H * W, 3), np.float32)
    acc = np.zeros((H * W,), np.float32)
    disp = np.zeros((H * W,), np.float32)
    if n:
        nb = -(-n // chunk)
        rays = ray_grid(c2w, focal, H, W, tl, br, nb * chunk, device)
        cyl_t = torch.as_tensor(cyl, device=device).expand(chunk, 5)
        sk = torch.as_tensor(skts, device=device).expand(chunk, N_JOINTS, 4, 4)
        fc = torch.full((chunk,), frame, dtype=torch.long, device=device)
        outs = []
        for b in range(nb):
            f, _ = render_rays(nets, model, rays[b * chunk:(b + 1) * chunk],
                               cyl_t, sk, fc, 2000.0, None, 0.0, 0.0, lowp)
            outs.append(torch.cat([f['rgb'], f['disp'][:, None],
                                   f['acc'][:, None]], -1))
        out = torch.cat(outs)[:n].cpu().numpy()
        a = out[:, 4:5]
        rgb[idx] = out[:, :3] * a + rgb[idx] * (1.0 - a)
        disp[idx] = np.nan_to_num(out[:, 3])
        acc[idx] = out[:, 4]
    return {'rgbs': rgb.reshape(H, W, 3), 'accs': acc.reshape(H, W),
            'disps': disp.reshape(H, W), 'box': (tl, br)}
