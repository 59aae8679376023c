"""K1: world->local transform + cutoff PE + full NeRF MLP forward in one
CUDA kernel (port of anerf_tpu/kernels/fused_render.py:fused_encode_mlp_pts).

The kernel source is csrc/fused_render.cu. It is built with nvcc for
sm_90a on first use into anerf_torch/_build/ and loaded with ctypes.
`fused_encode_mlp_pts` launches it for CUDA tensors and runs the plain
PyTorch version, `fused_encode_mlp_pts_ref`, for CPU tensors; it never
falls back from one to the other.

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

#: Kernel launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0

_SRC = Path(__file__).resolve().parent / 'csrc' / 'fused_render.cu'
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_LIB = None


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


def fused_encode_mlp_pts_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                             pts: torch.Tensor, m_all: torch.Tensor,
                             aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function in
    plain torch ops, from the same packed operands. bf16 operands, f32
    products and accumulation, activations rounded to bf16 between
    layers, as in the kernel."""
    R = pts.shape[0]
    x0, xv = _encode(packed, pts, m_all, aux, S, tau)
    W = ncfg.width
    ws, off = [], 0
    for n, k in layer_shapes(ncfg, packed['nfk'], packed['nfv']):
        ws.append(from_fragment_order(packed['w'][off:off + n * k], n, k)
                  .float())
        off += n * k
    bs = list(packed['b'][:W * (ncfg.depth + 1)].split(W)) + \
        [packed['b'][W * (ncfg.depth + 1):]]

    def layer(x, i, relu=True):
        y = x @ ws[i].t() + bs[i]
        return (torch.relu(y) if relu else y).to(torch.bfloat16).float()

    h = layer(x0, 0)
    for i in range(1, ncfg.depth):
        h = layer(torch.cat([x0, h], -1) if (i - 1) in ncfg.skips else h, i)
    feat = layer(h, ncfg.depth, relu=False)
    hv = layer(torch.cat([feat, xv], -1), ncfg.depth + 1)
    rgb = hv @ packed['w_rgb'].t() + packed['b_out'][:3]
    alpha = h @ packed['w_alpha'][:, None] + packed['b_out'][3:]
    return torch.cat([rgb, alpha], -1).reshape(R, S, 4)


def build_library() -> Tuple[Path, str]:
    """Compile csrc/fused_render.cu for sm_90a (once per source version)
    into anerf_torch/_build/. Returns (library path, nvcc's messages,
    which include ptxas' register and spill report)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    lib = _BUILD_DIR / f'fused_render_{digest}.so'
    if lib.exists():
        return lib, ''
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
           '-o', str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _library():
    global _LIB
    if _LIB is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        fn = lib.anerf_fused_encode_mlp_pts
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.anerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.anerf_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fused_encode_mlp_pts(ncfg: NeRFConfig, packed: Dict[str, Any],
                         pts: torch.Tensor, m_all: torch.Tensor,
                         aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """World points -> raw (R, S, 4): transform + cutoff PE + MLP.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global LAUNCHES
    if pts.device.type == 'cpu':
        return fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau)
    if pts.device.type != 'cuda':
        raise ValueError(f'fused_encode_mlp_pts: no kernel for {pts.device}')
    R = pts.shape[0]
    if ncfg.width != KERNEL_WIDTH:
        raise ValueError(f'the kernel is built for width {KERNEL_WIDTH}')
    if ncfg.depth > 31:
        raise ValueError('the kernel takes at most 31 trunk layers')
    if 4 * R * S >= 2 ** 31:
        raise ValueError('the kernel indexes points with 32-bit ints: '
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
    for name, (t, shape, dtype) in tensors.items():
        if t.device != pts.device or t.dtype != dtype \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f'fused_encode_mlp_pts: {name} must be a '
                             f'contiguous {dtype} {shape} on {pts.device}, '
                             f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    n_w = sum(n * k for n, k in layer_shapes(ncfg, packed['nfk'],
                                             packed['nfv']))
    if packed['w'].numel() != n_w:
        raise ValueError('packed weights do not match the config')
    out = torch.empty((R, S, 4), dtype=torch.float32, device=pts.device)
    if R * S == 0:
        return out
    lib = _library()
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
    if err != 0:
        raise RuntimeError('fused_encode_mlp_pts launch failed: '
                           + lib.anerf_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out
