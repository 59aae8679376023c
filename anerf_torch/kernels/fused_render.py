"""K1 and K2: the fused render kernels and the autograd.Function that
ties them together (port of anerf_tpu/kernels/fused_render.py).

K1 (`fused_encode_mlp_pts`, csrc/fused_render.cu) is the forward:
world->local transform + cutoff PE + the full NeRF MLP in one kernel.
K2 (`fused_bwd`, csrc/fused_render_bwd.cu) is its backward with f32
cotangent products (the JAX `bwd_f32=True` flavour). `FusedApply` /
`fused_apply` run K1 forward and K2 backward, with gradients reaching
the network's f32 parameter leaves, the points and the per-ray operands
(and through `pack_ray_data` the skeleton transforms and framecodes).

Each source is built with nvcc for sm_90a on first use into
anerf_torch/_build/ and loaded with ctypes. A wrapper launches its kernel
for CUDA tensors and runs the plain PyTorch version (`*_ref`) for CPU
tensors; it never falls back from one to the other.

Layouts (no TPU lane padding):
  pts    (R, S, 3) f32 world points;
  m_all  (R*3, 72) f32 rotation columns, m_all[3r+b, 3j+a] = skts[r,j,a,b];
  aux    (R, 160) f32 per-ray [trans (72) | unit view dirs (72) | fc (16)];
  out    (R, S, 4) f32 raw = [rgb logits (3), sigma].
Packed weights are bf16 blocks of (out, in) = (N, K), each K padded to a
multiple of 16 by zero columns (kp/bone input 432, already aligned at the
flagship; view input 664 -> 672), each block stored in the tensor cores'
B-fragment order (`to_fragment_order`) so that the kernel fetches a warp's
weights with one coalesced 16-byte load per lane.

Numerics: where the two JAX references round differently, the plain
version here follows the Pallas kernel, not the XLA `_dense` path: each
product `x_bf16 @ w_bf16` is kept in f32 before the bias add (XLA rounds
it to bf16 first; models/nerf.py mirrors that). Geometry is plain fp32
(the JAX kernel emulates it with hi/lo bf16 splits), the window is the
overflow-safe 1 / (1 + exp(tau (v - cut))), and sin/cos are the accurate
library functions (the JAX kernel uses a short polynomial, 3e-6 abs).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from ..models.nerf import NeRFConfig
from ..ops.encoding import _expand3, _group3_sumsq, rot_cols, rotate_flat

N_JOINTS = 24
C72 = 3 * N_JOINTS
FC_CH = 16                    # framecode columns the view block reserves
AUX_W = 2 * C72 + FC_CH
KERNEL_WIDTH = 256            # trunk width the CUDA kernel is built for

#: K1 launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0
#: K2 launches since the last reset; `fused_bwd` adds one per launch of
#: its kernel sequence.
BWD_LAUNCHES = 0
#: Points per partial sum of K2's weight gradients (one CTA row of the
#: dW products per chunk, reduced afterwards in chunk order).
BWD_CHUNK = 2048

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = {'fused_render': ('fused_render.cu', 'fused_render_common.cuh'),
            'fused_render_bwd': ('fused_render_bwd.cu',
                                 'fused_render_common.cuh')}
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_LIBS: Dict[str, Any] = {}


def _rup16(n: int) -> int:
    return -(-n // 16) * 16


def fused_render_supported(rcfg) -> bool:
    """Static check that the RenderConfig matches the kernel family (the
    JAX gate, plus the kernel's fixed width 256, a framecode width of 16
    and skips that feed a trunk layer)."""
    ek, ev, eb = rcfg.embed_kp, rcfg.embed_view, rcfg.embed_bone
    ncfg = rcfg.nerf
    return (
        rcfg.kp_dist_type == 'reldist'
        and rcfg.bone_type == 'reldir'
        and rcfg.view_type == 'relray'
        and rcfg.use_viewdirs
        and rcfg.skel.n_joints == N_JOINTS
        and ek is not None and ek.cutoff and ek.cutoff_inputs
        and not ek.dist_inputs and not ek.cut_to_cutoff
        and not ek.shift_inputs and not ek.normalize
        and not ek.freq_schedule
        and ev is not None and ev.cutoff and ev.cutoff_inputs
        and ev.dist_inputs and not ev.freq_schedule and not ev.normalize
        and (eb is None or eb.num_freqs == 0)
        and ncfg.input_ch == N_JOINTS * (1 + 2 * ek.num_freqs)
        and ncfg.input_ch_bones == C72
        and ncfg.input_ch_views == C72 * (1 + 2 * ev.num_freqs)
        and ncfg.width == KERNEL_WIDTH
        and all(s < ncfg.depth - 1 for s in ncfg.skips)
        and (not ncfg.use_framecode or ncfg.framecode_ch == FC_CH)
    )


def input_widths(nfk: int, nfv: int) -> Tuple[int, int, int, int]:
    """(k0, k0p, kv, kvp): kp+bone input width and the view-block width
    (view PE + framecode), each with its 16-padded size."""
    k0 = N_JOINTS * (1 + 2 * nfk) + C72
    kv = C72 * (1 + 2 * nfv) + FC_CH
    return k0, _rup16(k0), kv, _rup16(kv)


def layer_shapes(ncfg: NeRFConfig, nfk: int, nfv: int
                 ) -> List[Tuple[int, int]]:
    """(N, K) of each packed weight block, in the order the kernel walks
    the flat buffer: trunk layers, feature layer, view layer."""
    W = ncfg.width
    _, k0p, _, kvp = input_widths(nfk, nfv)
    shapes = []
    for i in range(ncfg.depth):
        if i == 0:
            shapes.append((W, k0p))
        elif (i - 1) in ncfg.skips:
            shapes.append((W, k0p + W))
        else:
            shapes.append((W, W))
    shapes.append((W, W))
    shapes.append((W // 2, W + kvp))
    return shapes


def to_fragment_order(w: torch.Tensor) -> torch.Tensor:
    """An (N, K) weight block (N, K multiples of 16) -> the flat order of
    mma.m16n8k16 B fragments: per 16-deep k-step, per pair of 8-row
    n-tiles, per lane (g = lane // 4, t = lane % 4) the 8 values
    w[n, k+2t], w[n, k+2t+1], w[n, k+2t+8], w[n, k+2t+9] for n = 16 pair
    + g, then the same four for n + 8."""
    N, K = w.shape
    # axes (pair, half, g, kstep, hi, t, e): n = 16 pair + 8 half + g,
    # k = 16 kstep + 8 hi + 2 t + e
    return (w.reshape(N // 16, 2, 8, K // 16, 2, 4, 2)
            .permute(3, 0, 2, 5, 1, 4, 6).reshape(-1))


def from_fragment_order(flat: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Inverse of to_fragment_order: the flat block back to (N, K)."""
    return (flat.reshape(K // 16, N // 16, 8, 4, 2, 2, 2)
            .permute(1, 4, 2, 0, 5, 3, 6).reshape(N, K))


def pack_render_params(params: Dict[str, Any], ncfg: NeRFConfig,
                       n_freq_kp: int, n_freq_view: int,
                       cutoff_dist: torch.Tensor) -> Dict[str, Any]:
    """One network's params -> the kernel's operands.

    'w' is every MMA layer's (N, K) bf16 block in fragment order, in
    `layer_shapes` order; 'b' the matching f32 biases. The 3-wide rgb and
    1-wide alpha heads run on the CUDA cores in f32 on bf16-rounded
    weights ('w_rgb' (3, W/2), 'w_alpha' (W,), 'b_out' (4,)).
    """
    W = ncfg.width
    dnet = ncfg.dnet_input
    k0, k0p, _, kvp = input_widths(n_freq_kp, n_freq_view)
    dev = cutoff_dist.device

    def rows(w, n):          # zero-pad the input (row) axis to n
        return torch.cat([w, w.new_zeros((n - w.shape[0], w.shape[1]))], 0)

    blocks, biases = [], []
    for i, layer in enumerate(params['pts_linears']):
        w = layer['w']
        if i == 0:
            w = rows(w, k0p)
        elif (i - 1) in ncfg.skips:
            w = torch.cat([rows(w[:dnet], k0p), w[dnet:]], 0)
        blocks.append(w.t())
        biases.append(layer['b'])
    blocks.append(params['feature_linear']['w'].t())
    biases.append(params['feature_linear']['b'])
    vl = params['views_linears'][0]
    n_view = ncfg.input_ch_views + (ncfg.framecode_ch
                                    if ncfg.use_framecode else 0)
    vw = vl['w'].new_zeros((W + kvp, W // 2))
    vw[:W + n_view] = vl['w']
    blocks.append(vw.t())
    biases.append(vl['b'])

    bf = torch.bfloat16
    return {
        'w': torch.cat([to_fragment_order(b.to(bf)) for b in blocks])
        .contiguous(),
        'b': torch.cat(biases).float().contiguous(),
        'w_rgb': params['rgb_linear']['w'].t().to(bf).float().contiguous(),
        'w_alpha': params['alpha_linear']['w'][:, 0].to(bf).float()
        .contiguous(),
        'b_out': torch.cat([params['rgb_linear']['b'],
                            params['alpha_linear']['b']]).float()
        .contiguous(),
        'cut': cutoff_dist.reshape(-1)[:N_JOINTS].float().to(dev)
        .contiguous(),
        'nfk': int(n_freq_kp), 'nfv': int(n_freq_view),
    }


def pack_ray_data(rays_d: torch.Tensor, skts: torch.Tensor,
                  framecodes: torch.Tensor | None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray kernel operands: rays_d (R, 1, 3), skts (R, J, 4, 4),
    framecodes (R, 16) or None -> m_all (R*3, 72), aux (R, 160)."""
    R, J = skts.shape[0], skts.shape[1]
    cols = rot_cols(skts)                                  # (R, 3, 72)
    trans = skts[..., :3, 3].reshape(R, J * 3)
    rays_flat = rotate_flat(rays_d, cols)[:, 0]            # (R, 72)
    dss = _group3_sumsq(rays_flat, J)
    d = rays_flat * _expand3(torch.rsqrt(torch.clamp_min(dss, 1e-24)), J)
    if framecodes is None:
        framecodes = rays_flat.new_zeros((R, FC_CH))
    if framecodes.shape[-1] != FC_CH:
        raise ValueError(f'framecodes must be (R, {FC_CH})')
    aux = torch.cat([trans, d, framecodes.to(d.dtype)], -1)
    return (cols.reshape(R * 3, J * 3).float().contiguous(),
            aux.float().contiguous())


def _encode(packed, pts, m_all, aux, S, tau):
    """The kernel's phase A in plain torch: the bf16-rounded MLP inputs
    x0 (R, S, k0p) and xv (R, S, kvp), as f32 values."""
    nfk, nfv = packed['nfk'], packed['nfv']
    k0, k0p, kv, kvp = input_widths(nfk, nfv)
    R, J = pts.shape[0], N_JOINTS
    m = m_all.reshape(R, 3, C72)
    trans, d, fc = aux[:, :C72], aux[:, C72:2 * C72], aux[:, 2 * C72:]

    pts_t = rotate_flat(pts, m) + trans[:, None]           # (R, S, 72)
    v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_t, J), 1e-24))
    r = pts_t * _expand3(1.0 / torch.clamp_min(v, 1e-12), J)
    w24 = torch.sigmoid(-tau * (v - packed['cut']))        # 1 - sigmoid

    def bands(x, n):        # (..., D) -> (..., 1 + 2n, D): [x, s0, c0, ..]
        f = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
        ang = x[..., None, :] * f[:, None]
        sc = torch.stack([torch.sin(ang), torch.cos(ang)], -2)
        return torch.cat([x[..., None, :],
                          sc.reshape(*x.shape[:-1], 2 * n, x.shape[-1])], -2)

    kp = (bands(v, nfk) * w24[..., None, :]).reshape(R, S, k0 - C72)
    x0 = torch.cat([kp, r, pts.new_zeros((R, S, k0p - k0))], -1)
    w72 = _expand3(w24, J)
    vb = bands(d, nfv)[:, None] * w72[:, :, None, :]       # (R, S, K, 72)
    xv = torch.cat([vb.reshape(R, S, kv - FC_CH),
                    fc[:, None].expand(R, S, FC_CH),
                    pts.new_zeros((R, S, kvp - kv))], -1)
    bf = torch.bfloat16
    return x0.to(bf).float(), xv.to(bf).float()


def _weights_f32(ncfg: NeRFConfig, packed: Dict[str, Any]
                 ) -> List[torch.Tensor]:
    """Every MMA layer's (N, K) weight block back from fragment order, as
    f32 (bf16 values), in `layer_shapes` order."""
    ws, off = [], 0
    for n, k in layer_shapes(ncfg, packed['nfk'], packed['nfv']):
        ws.append(from_fragment_order(packed['w'][off:off + n * k], n, k)
                  .float())
        off += n * k
    return ws


def _forward_trace(ncfg: NeRFConfig, packed: Dict[str, Any],
                   pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                   S: int, tau) -> Dict[str, Any]:
    """The kernel's forward in plain torch, keeping what the backward
    reads: the MLP inputs x0 / xv, every trunk activation hs[i], feat and
    hv (each bf16-rounded, as f32) and the raw output."""
    x0, xv = _encode(packed, pts, m_all, aux, S, tau)
    W = ncfg.width
    ws = _weights_f32(ncfg, packed)
    bs = list(packed['b'][:W * (ncfg.depth + 1)].split(W)) + \
        [packed['b'][W * (ncfg.depth + 1):]]

    def layer(x, i, relu=True):
        y = x @ ws[i].t() + bs[i]
        return (torch.relu(y) if relu else y).to(torch.bfloat16).float()

    hs = [layer(x0, 0)]
    for i in range(1, ncfg.depth):
        hs.append(layer(torch.cat([x0, hs[-1]], -1)
                        if (i - 1) in ncfg.skips else hs[-1], i))
    feat = layer(hs[-1], ncfg.depth, relu=False)
    hv = layer(torch.cat([feat, xv], -1), ncfg.depth + 1)
    rgb = hv @ packed['w_rgb'].t() + packed['b_out'][:3]
    alpha = hs[-1] @ packed['w_alpha'][:, None] + packed['b_out'][3:]
    return {'x0': x0, 'xv': xv, 'hs': hs, 'feat': feat, 'hv': hv, 'ws': ws,
            'out': torch.cat([rgb, alpha], -1)}


def fused_encode_mlp_pts_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                             pts: torch.Tensor, m_all: torch.Tensor,
                             aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """The plain PyTorch version of K1: the same function in plain torch
    ops, from the same packed operands. bf16 operands, f32 products and
    accumulation, activations rounded to bf16 between layers, as in the
    kernel."""
    R = pts.shape[0]
    out = _forward_trace(ncfg, packed, pts, m_all, aux, S, tau)['out']
    return out.reshape(R, S, 4)


def grad_blocks(ncfg: NeRFConfig, nfk: int, nfv: int
                ) -> List[Tuple[str, int, int]]:
    """(name, rows, cols) of each block of K2's flat weight gradient, in
    order: trunk layers 'l0'.., 'feat', 'view' (rows = the packed input
    width K, then one bias row; cols = the layer's outputs N), then the
    heads 'rgb' (W/2 + 1, 3) and 'alpha' (W + 1, 1)."""
    names = [f'l{i}' for i in range(ncfg.depth)] + ['feat', 'view']
    blocks = [(nm, k + 1, n) for nm, (n, k) in
              zip(names, layer_shapes(ncfg, nfk, nfv))]
    W = ncfg.width
    return blocks + [('rgb', W // 2 + 1, 3), ('alpha', W + 1, 1)]


def split_grads(ncfg: NeRFConfig, nfk: int, nfv: int, dW: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """K2's flat weight gradient -> {name: (rows, cols) view}; the last
    row of each block is the bias gradient."""
    out, off = {}, 0
    for nm, r, c in grad_blocks(ncfg, nfk, nfv):
        out[nm] = dW[off:off + r * c].view(r, c)
        off += r * c
    if off != dW.numel():
        raise ValueError('weight gradient does not match the config')
    return out


def _pe_transform_bwd_ref(packed, pts, m_all, aux, S, tau, dx0, dxv):
    """Backward of the cutoff PE and the world->local transform in exact
    fp32 (the pose-refinement path): cotangents of the MLP inputs dx0
    (R, S, k0p) and dxv (R, S, kvp) -> dpts (R, S, 3), dm_all (R*3, 72),
    daux (R, 160). Mirrors K2's last kernel term by term."""
    nfk, nfv = packed['nfk'], packed['nfv']
    R, J = pts.shape[0], N_JOINTS
    m = m_all.reshape(R, 3, C72)
    trans, d = aux[:, :C72], aux[:, C72:2 * C72]
    pts_t = rotate_flat(pts, m) + trans[:, None]           # (R, S, 72)
    v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_t, J), 1e-24))
    inv = 1.0 / torch.clamp_min(v, 1e-12)
    w = torch.sigmoid(-tau * (v - packed['cut']))          # (R, S, 24)

    nb = J * (1 + 2 * nfk)
    dv = dx0[..., :J] * w
    dw = dx0[..., :J] * v
    for k in range(nfk):
        f = float(2 ** k)
        sn, cs = torch.sin(v * f), torch.cos(v * f)
        dsv = dx0[..., J + 2 * J * k:2 * J + 2 * J * k]
        dcv = dx0[..., 2 * J + 2 * J * k:3 * J + 2 * J * k]
        dv = dv + f * (dsv * cs - dcv * sn) * w
        dw = dw + (dsv * sn + dcv * cs)
    w72 = _expand3(w, J)
    dd = dxv[..., :C72] * w72
    dw72 = dxv[..., :C72] * d[:, None]
    for k in range(nfv):
        f = float(2 ** k)
        sn, cs = torch.sin(d * f)[:, None], torch.cos(d * f)[:, None]
        dsd = dxv[..., C72 + 2 * C72 * k:2 * C72 + 2 * C72 * k]
        dcd = dxv[..., 2 * C72 + 2 * C72 * k:3 * C72 + 2 * C72 * k]
        dd = dd + f * (dsd * cs - dcd * sn) * w72
        dw72 = dw72 + (dsd * sn + dcd * cs)
    dw = dw + dw72.reshape(*dw72.shape[:-1], J, 3).sum(-1)
    dv = dv + tau * dw * (-(1.0 - w) * w)                  # w = 1 - sigmoid

    drb = dx0[..., nb:nb + C72]
    dpts_t = drb * _expand3(inv, J)
    dvinv = (drb * pts_t).reshape(R, S, J, 3).sum(-1)
    dv = dv - dvinv * inv * inv * (v > 1e-12)
    dv2s = dv * 0.5 * inv
    dpts_t = dpts_t + _expand3(dv2s, J) * 2.0 * pts_t

    dpts = (dpts_t[:, :, None, :] * m[:, None]).sum(-1)    # (R, S, 3)
    dm = (pts[..., :, None] * dpts_t[..., None, :]).sum(1)  # (R, 3, 72)
    fc0 = C72 * (1 + 2 * nfv)
    daux = torch.cat([dpts_t.sum(1), dd.sum(1),
                      dxv[..., fc0:fc0 + FC_CH].sum(1)], -1)
    return dpts, dm.reshape(R * 3, C72), daux


def fused_bwd_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                  pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                  S: int, tau, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The plain PyTorch version of K2: recompute the forward, then the
    backward with f32 cotangent products, for the cotangent g (R, S, 4)
    of K1's output. ReLU masks come from the bf16-rounded activations.
    Returns (dW flat in `grad_blocks` layout, dpts (R, S, 3),
    dm_all (R*3, 72), daux (R, 160))."""
    R = pts.shape[0]
    P = R * S
    t = _forward_trace(ncfg, packed, pts, m_all, aux, S, tau)
    ws, hs = t['ws'], t['hs']
    flat = lambda x: x.reshape(P, x.shape[-1])
    x0, xv, feat, hv = (flat(t[k]) for k in ('x0', 'xv', 'feat', 'hv'))
    hs = [flat(h) for h in hs]
    g2 = g.reshape(P, 4).float()
    W, depth = ncfg.width, ncfg.depth
    k0p = x0.shape[-1]

    def block(x, dy):           # (K + 1, N): x^T dy, then the bias row
        return torch.cat([x.t() @ dy, dy.sum(0, keepdim=True)])

    grads = {'rgb': block(hv, g2[:, :3]), 'alpha': block(hs[-1], g2[:, 3:])}
    dhv = (g2[:, :3] @ packed['w_rgb']) * (hv > 0)
    grads['view'] = block(torch.cat([feat, xv], -1), dhv)
    dview = dhv @ ws[depth + 1]
    dfeat, dxv = dview[:, :W], dview[:, W:]
    grads['feat'] = block(hs[-1], dfeat)
    dh = (dfeat @ ws[depth] + g2[:, 3:] * packed['w_alpha']) * (hs[-1] > 0)
    dx0 = torch.zeros_like(x0)
    for i in range(depth - 1, 0, -1):
        skip = (i - 1) in ncfg.skips
        grads[f'l{i}'] = block(torch.cat([x0, hs[i - 1]], -1) if skip
                               else hs[i - 1], dh)
        din = dh @ ws[i]
        if skip:
            dx0 = dx0 + din[:, :k0p]
            din = din[:, k0p:]
        dh = din * (hs[i - 1] > 0)
    grads['l0'] = block(x0, dh)
    dx0 = dx0 + dh @ ws[0]

    dW = torch.cat([grads[nm].reshape(-1) for nm, _, _ in
                    grad_blocks(ncfg, packed['nfk'], packed['nfv'])])
    dpts, dm, daux = _pe_transform_bwd_ref(
        packed, pts, m_all, aux, S, tau, dx0.reshape(R, S, k0p),
        dxv.reshape(R, S, dxv.shape[-1]))
    return dW, dpts, dm, daux


def build_library(name: str) -> Tuple[Path, str]:
    """Compile one kernel source ('fused_render' = K1, 'fused_render_bwd'
    = K2) for sm_90a into anerf_torch/_build/, once per version of its
    sources. Returns (library path, nvcc's messages, which include
    ptxas' register and spill report)."""
    srcs = [_CSRC / f for f in _SOURCES[name]]
    digest = hashlib.sha256(b''.join(p.read_bytes() for p in srcs)
                            ).hexdigest()[:12]
    lib = _BUILD_DIR / f'{name}_{digest}.so'
    if lib.exists():
        return lib, ''
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
           '-o', str(tmp), str(srcs[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name} ({proc.returncode}):\n'
                           f'{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build_libraries() -> Dict[str, Tuple[Path, str]]:
    """Build every kernel library at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(_SOURCES)) as pool:
        futs = {n: pool.submit(build_library, n) for n in _SOURCES}
        return {n: f.result() for n, f in futs.items()}


def _library(name: str):
    if name not in _LIBS:
        path, _ = build_library(name)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == 'fused_render':
            lib.anerf_fused_encode_mlp_pts.argtypes = \
                [p] * 10 + [i] * 6 + [f, p]
            lib.anerf_fused_encode_mlp_pts.restype = i
        else:
            lib.anerf_fused_bwd.argtypes = [p] * 23 + [i] * 7 + [f, p]
            lib.anerf_fused_bwd.restype = i
        lib.anerf_cuda_error_string.argtypes = [i]
        lib.anerf_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _check_operands(fn: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                    pts: torch.Tensor, m_all: torch.Tensor,
                    aux: torch.Tensor, S: int, **extra) -> None:
    """Raise unless every operand is what the kernels take: contiguous,
    of the right type and shape, on the points' CUDA device."""
    if pts.device.type != 'cuda':
        raise ValueError(f'{fn}: no kernel for {pts.device}')
    R = pts.shape[0]
    if ncfg.width != KERNEL_WIDTH:
        raise ValueError(f'the kernels are built for width {KERNEL_WIDTH}')
    if ncfg.depth > 31:
        raise ValueError('the kernels take at most 31 trunk layers')
    if 4 * R * S >= 2 ** 31:
        raise ValueError('the kernels index points with 32-bit ints: '
                         f'R * S = {R * S} is too many; split the rays')
    tensors = {'pts': (pts, (R, S, 3), torch.float32),
               'm_all': (m_all, (R * 3, C72), torch.float32),
               'aux': (aux, (R, AUX_W), torch.float32),
               'w': (packed['w'], None, torch.bfloat16),
               'b': (packed['b'], None, torch.float32),
               'w_rgb': (packed['w_rgb'], (3, KERNEL_WIDTH // 2),
                         torch.float32),
               'w_alpha': (packed['w_alpha'], (KERNEL_WIDTH,),
                           torch.float32),
               'b_out': (packed['b_out'], (4,), torch.float32),
               'cut': (packed['cut'], (N_JOINTS,), torch.float32)}
    tensors.update(extra)
    for name, (t, shape, dtype) in tensors.items():
        if t.device != pts.device or t.dtype != dtype \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f'{fn}: {name} must be a contiguous {dtype} '
                             f'{shape} on {pts.device}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    n_w = sum(n * k for n, k in layer_shapes(ncfg, packed['nfk'],
                                             packed['nfv']))
    if packed['w'].numel() != n_w:
        raise ValueError('packed weights do not match the config')


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f'{fn} launch failed: '
                           + lib.anerf_cuda_error_string(err).decode())


def fused_encode_mlp_pts(ncfg: NeRFConfig, packed: Dict[str, Any],
                         pts: torch.Tensor, m_all: torch.Tensor,
                         aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """K1: world points -> raw (R, S, 4): transform + cutoff PE + MLP.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global LAUNCHES
    if pts.device.type == 'cpu':
        return fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau)
    _check_operands('fused_encode_mlp_pts', ncfg, packed, pts, m_all, aux, S)
    R = pts.shape[0]
    out = torch.empty((R, S, 4), dtype=torch.float32, device=pts.device)
    if R * S == 0:
        return out
    lib = _library('fused_render')
    skip_mask = sum(1 << s for s in ncfg.skips)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.anerf_fused_encode_mlp_pts(
            pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['w'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            out.data_ptr(), R * S, S, ncfg.depth, skip_mask,
            packed['nfk'], packed['nfv'], float(tau), stream)
    _raise_on(lib, err, 'fused_encode_mlp_pts')
    LAUNCHES += 1
    return out


def fused_bwd(ncfg: NeRFConfig, packed: Dict[str, Any], pts: torch.Tensor,
              m_all: torch.Tensor, aux: torch.Tensor, S: int, tau,
              g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """K2: the backward of K1 for the cotangent g (R, S, 4) of its output.
    Returns (dW flat in `grad_blocks` layout, dpts (R, S, 3),
    dm_all (R*3, 72), daux (R, 160)), all f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    sequence of csrc/fused_render_bwd.cu (and raise if it cannot launch).
    The sequence allocates its scratch here: the saved bf16 activations
    (2 * (k0p + kvp + (depth + 1) W + W/2) bytes per point, 7,072 at the
    flagship), the f32 cotangents and the per-chunk dW partial sums."""
    global BWD_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g)
    R = pts.shape[0]
    _check_operands('fused_bwd', ncfg, packed, pts, m_all, aux, S,
                    g=(g, (R, S, 4), torch.float32))
    nfk, nfv = packed['nfk'], packed['nfv']
    _, k0p, _, kvp = input_widths(nfk, nfv)
    W, WV, P = ncfg.width, ncfg.width // 2, R * S
    dev = pts.device
    n_grad = sum(r * c for _, r, c in grad_blocks(ncfg, nfk, nfv))
    dW = torch.zeros((n_grad,), dtype=torch.float32, device=dev)
    dpts = torch.zeros((R, S, 3), dtype=torch.float32, device=dev)
    dm = torch.zeros((R * 3, C72), dtype=torch.float32, device=dev)
    daux = torch.zeros((R, AUX_W), dtype=torch.float32, device=dev)
    if P == 0:
        return dW, dpts, dm, daux
    w32 = torch.cat([w.reshape(-1) for w in _weights_f32(ncfg, packed)])
    n_chunk = -(-P // BWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=dev)
    act = torch.empty((P, k0p + kvp + (ncfg.depth + 1) * W + WV),
                      dtype=torch.bfloat16, device=dev)
    scratch = [torch.empty((P, 4), **f32),             # K1's raw output
               torch.empty((P, WV), **f32),            # d hv
               torch.empty((P, W + kvp), **f32),       # d [feat | xv]
               torch.empty((P, W), **f32),             # d h, ping
               torch.empty((P, W), **f32),             # d h, pong
               torch.empty((P, k0p), **f32),           # d x0
               torch.empty((n_chunk, n_grad), **f32)]  # dW partial sums
    lib = _library('fused_render_bwd')
    skip_mask = sum(1 << s for s in ncfg.skips)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.anerf_fused_bwd(
            pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['w'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            w32.data_ptr(), g.data_ptr(), act.data_ptr(),
            *(t.data_ptr() for t in scratch),
            dW.data_ptr(), dpts.data_ptr(), dm.data_ptr(), daux.data_ptr(),
            P, S, ncfg.depth, skip_mask, nfk, nfv, BWD_CHUNK, float(tau),
            stream)
    _raise_on(lib, err, 'fused_bwd')
    BWD_LAUNCHES += 1
    return dW, dpts, dm, daux


def _net_leaves(ncfg: NeRFConfig, net: Dict[str, Any]
                ) -> List[torch.Tensor]:
    """The f32 parameter leaves the kernels read, in a fixed order: the
    trunk's (w, b) per layer, then feature, view, rgb and alpha (w, b)."""
    layers = (list(net['pts_linears']) + [net['feature_linear'],
                                          net['views_linears'][0],
                                          net['rgb_linear'],
                                          net['alpha_linear']])
    return [x for layer in layers for x in (layer['w'], layer['b'])]


def _net_from_leaves(ncfg: NeRFConfig, leaves) -> Dict[str, Any]:
    lin = [{'w': leaves[2 * i], 'b': leaves[2 * i + 1]}
           for i in range(len(leaves) // 2)]
    d = ncfg.depth
    return {'pts_linears': lin[:d], 'feature_linear': lin[d],
            'views_linears': [lin[d + 1]], 'rgb_linear': lin[d + 2],
            'alpha_linear': lin[d + 3]}


def _leaf_grads(ncfg: NeRFConfig, nfk: int, nfv: int, dW: torch.Tensor
                ) -> List[torch.Tensor]:
    """K2's weight-gradient blocks -> gradients of `_net_leaves`: drop the
    zero padding rows, split the skip layer's [x0 | h] rows back into the
    (dnet + W, W) leaf. Weight gradients are rounded to bf16, as the JAX
    VJP casts them to the packed weights' dtype; biases stay f32."""
    blocks = split_grads(ncfg, nfk, nfv, dW)
    k0, k0p, _, _ = input_widths(nfk, nfv)
    W, bf = ncfg.width, torch.bfloat16
    n_view = ncfg.input_ch_views + (ncfg.framecode_ch
                                    if ncfg.use_framecode else 0)
    rows = []
    for i in range(ncfg.depth):
        b = blocks[f'l{i}']
        if i == 0:
            rows.append((b[:k0], b[-1]))
        elif (i - 1) in ncfg.skips:
            rows.append((torch.cat([b[:k0], b[k0p:k0p + W]]), b[-1]))
        else:
            rows.append((b[:W], b[-1]))
    rows += [(blocks['feat'][:W], blocks['feat'][-1]),
             (blocks['view'][:W + n_view], blocks['view'][-1]),
             (blocks['rgb'][:W // 2], blocks['rgb'][-1]),
             (blocks['alpha'][:W], blocks['alpha'][-1])]
    return [x for w, b in rows for x in (w.to(bf).float(), b.clone())]


class FusedApply(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX `fused_apply` custom VJP). The
    forward packs the network's f32 leaves into the kernel operands
    (no grad) and keeps only pts, m_all and aux: K2 recomputes the
    forward. cutoff_dist and tau get no gradient by design (never
    trained; tau is a schedule)."""

    @staticmethod
    def forward(ctx, ncfg, S, tau, nfk, nfv, cutoff_dist, pts, m_all, aux,
                *leaves):
        packed = pack_render_params(_net_from_leaves(ncfg, leaves), ncfg,
                                    nfk, nfv, cutoff_dist)
        ctx.save_for_backward(pts, m_all, aux)
        ctx.packed, ctx.ncfg, ctx.S, ctx.tau = packed, ncfg, S, tau
        return fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)

    @staticmethod
    def backward(ctx, g):
        pts, m_all, aux = ctx.saved_tensors
        p = ctx.packed
        dW, dpts, dm, daux = fused_bwd(ctx.ncfg, p, pts, m_all, aux, ctx.S,
                                       ctx.tau, g.contiguous().float())
        return (None,) * 6 + (dpts, dm, daux) + tuple(
            _leaf_grads(ctx.ncfg, p['nfk'], p['nfv'], dW))


def fused_apply(ncfg: NeRFConfig, S: int, net: Dict[str, Any],
                cutoff_dist: torch.Tensor, n_freq_kp: int, n_freq_view: int,
                pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                tau) -> torch.Tensor:
    """Differentiable fused transform + PE + MLP: (R, S, 3) world points
    -> raw (R, S, 4) through K1, with K2 as its backward. Gradients reach
    the leaves of `net` (one network's params), pts, m_all and aux."""
    return FusedApply.apply(ncfg, S, float(tau), int(n_freq_kp),
                            int(n_freq_view), cutoff_dist, pts, m_all, aux,
                            *_net_leaves(ncfg, net))
