"""K1, K2 and K3: the fused render kernels and the autograd.Function that
ties K1 and K2 together (port of anerf_tpu/kernels/fused_render.py).

K1 (`fused_encode_mlp_pts`, csrc/fused_render_sm90.cu) is the forward:
world->local transform + cutoff PE + the full NeRF MLP in one kernel, on
wgmma with the weights staged in shared memory by cluster-multicast bulk
copies from the weight image 'img' (`to_sm90_image`). K1-v1
(`fused_encode_mlp_pts_v1`, csrc/fused_render.cu) is its first, mma.sync
version, kept as the comparison; no path of the port runs it.
K2 (`fused_bwd`, csrc/fused_render_bwd_sm90.cu after a recompute by K1's
kernel with SAVE) is its backward, in the two flavours of the JAX
kernel. With f32-accurate cotangent products (`bwd_f32=True`) they are
split-bf16 wgmma GEMMs: the f32 cotangent splits exactly into three bf16
planes (`split3_ref`), each multiplied by the bf16 weights or saved
activations. With bf16 cotangent operands (`bwd_f32=False`, the
--fast_grads numerics) the same launches multiply the hi plane alone,
the cotangent rounded to bf16, and the heads round g the same way. The
weights' second image 'W^T' (`t_image_index`) and the saved activations'
tile layout (`act_image`) feed them. K2-v1 (`fused_bwd_v1`,
csrc/fused_render_bwd.cu, f32 FMA GEMMs) is its first version, kept as
the comparison; no path of the port runs it. `FusedApply` /
`fused_apply` run K1 forward and K2 backward, with gradients reaching
the network's f32 parameter leaves, the points and the per-ray operands
(and through `pack_ray_data` the skeleton transforms and framecodes).
K3 (`fused_encode_mlp`, csrc/fused_render_sm90.cu, K1's kernel in its
IN_RAW mode) is K1 without the transform: the cutoff PE + MLP of
per-point raw inputs made by `build_raw_inputs`, from the same weight
image. K3-v1 (`fused_encode_mlp_v1`, csrc/fused_render_modes.cu, K1-v1's
body) is its first version, kept as the comparison; no path of the port
runs it. The plain versions of K1, K3 and K4 (kernels/fused_mlp.py)
share one MLP (`mlp_trace`).

Each source is built with nvcc for sm_90a on first use into
anerf_torch/_build/ and loaded with ctypes. A wrapper launches its kernel
for CUDA tensors and runs the plain PyTorch version (`*_ref`) for CPU
tensors; it never falls back from one to the other.

Layouts (no TPU lane padding):
  pts    (R, S, 3) f32 world points;
  m_all  (R*3, 72) f32 rotation columns, m_all[3r+b, 3j+a] = skts[r,j,a,b];
  aux    (R, 160) f32 per-ray [trans (72) | unit view dirs (72) | fc (16)];
  x_raw  (..., 184) f32 per-point [v (24) | r (72) | d (72) | fc (16)]
         (K3's input; the TPU kernel's is 512 lanes, four 128-lane
         segments);
  out    (R, S, 4) f32 raw = [rgb logits (3), sigma].
Packed weights are bf16 blocks of (out, in) = (N, K), each K padded to a
multiple of 16 by zero columns (kp/bone input 432, already aligned at the
flagship; view input 664 -> 672), each block stored in the tensor cores'
B-fragment order (`to_fragment_order`, 'w': K1-v1, K2, K3-v1, K4-v1) so
that the kernel fetches a warp's weights with one coalesced 16-byte load
per lane. K1, K3 and K4 read their own image of the same blocks ('img',
`image_index`), each input segment padded to a multiple of 64 (432 ->
448, 664 -> 704).

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
from ..ops.encoding import (_expand3, _group3_sumsq, rot_cols, rotate_flat,
                            transform_batch_pts_flat)

N_JOINTS = 24
C72 = 3 * N_JOINTS
FC_CH = 16                    # framecode columns the view block reserves
AUX_W = 2 * C72 + FC_CH
RAW_W = N_JOINTS + 2 * C72 + FC_CH   # K3's input row: v | r | d | fc
KERNEL_WIDTH = 256            # trunk width the CUDA kernel is built for

#: K1 launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0
#: K1-v1 launches since the last reset; `fused_encode_mlp_pts_v1` adds
#: one per launch.
V1_LAUNCHES = 0
#: K2 launches since the last reset; `fused_bwd` adds one per launch of
#: its kernel sequence in the f32 flavour (bwd_f32).
BWD_LAUNCHES = 0
#: K2 launches in the bf16 flavour (not bwd_f32) since the last reset;
#: `fused_bwd` adds one per launch of its kernel sequence.
BWD_BF16_LAUNCHES = 0
#: K2-v1 launches since the last reset; `fused_bwd_v1` adds one per
#: launch of its kernel sequence.
BWD_V1_LAUNCHES = 0
#: K3 launches since the last reset; `fused_encode_mlp` adds one per
#: launch.
RAW_LAUNCHES = 0
#: K3-v1 launches since the last reset; `fused_encode_mlp_v1` adds one per
#: launch.
RAW_V1_LAUNCHES = 0
#: Points per partial sum of K2's weight gradients (one CTA row of the
#: dW products per chunk, reduced afterwards in chunk order).
BWD_CHUNK = 2048

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = {'fused_render_sm90': ('fused_render_sm90.cu', 'sm90_common.cuh',
                                  'fused_render_common.cuh'),
            'fused_render': ('fused_render.cu', 'fused_render_common.cuh'),
            'fused_render_bwd_sm90': ('fused_render_bwd_sm90.cu',
                                      'sm90_common.cuh',
                                      'fused_render_bwd_common.cuh',
                                      'fused_render_common.cuh'),
            'fused_render_bwd': ('fused_render_bwd.cu',
                                 'fused_render_bwd_common.cuh',
                                 'fused_render_common.cuh'),
            'fused_render_modes': ('fused_render_modes.cu',
                                   'fused_render_common.cuh')}
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_LIBS: Dict[str, Any] = {}


def _rup16(n: int) -> int:
    return -(-n // 16) * 16


#: depth of a k-slice of K1's weight image: one 128-byte swizzle row of
#: bf16 (csrc/fused_render_sm90.cu: KC)
SLICE_K = 64


def _rup64(n: int) -> int:
    return -(-n // SLICE_K) * SLICE_K


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
    _, k0p, _, kvp = input_widths(nfk, nfv)
    return mlp_shapes(ncfg, k0p, kvp)


def mlp_shapes(ncfg: NeRFConfig, k0p: int, kvp: int
               ) -> List[Tuple[int, int]]:
    """`layer_shapes` for MLP input blocks of k0p and kvp columns."""
    W = ncfg.width
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


def _swizzle_index(N: int, device) -> torch.Tensor:
    """(N, 8) gather index of the 128-byte swizzle: row n keeps the 16-byte
    group g of a k-slice at position g ^ (n % 8) (an involution)."""
    n = torch.arange(N, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (n % 8)


def to_sm90_image(w: torch.Tensor) -> torch.Tensor:
    """An (N, K) weight block (N a multiple of 8, K of 64) -> its k-slices
    as the shared-memory image wgmma reads as a K-major B operand with the
    128-byte swizzle: per 64-deep slice, row n's 128 bytes at n * 128, its
    16-byte group h holding columns 8 (h ^ (n % 8)) .. + 7 of the slice."""
    N, K = w.shape
    x = w.reshape(N, K // SLICE_K, 8, 8).permute(1, 0, 2, 3)
    idx = _swizzle_index(N, w.device)[None, :, :, None].expand(x.shape)
    return torch.gather(x, 2, idx).reshape(-1)


def from_sm90_image(flat: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Inverse of to_sm90_image: the flat slices back to (N, K)."""
    x = flat.reshape(K // SLICE_K, N, 8, 8)
    idx = _swizzle_index(N, flat.device)[None, :, :, None].expand(x.shape)
    return torch.gather(x, 2, idx).permute(1, 0, 2, 3).reshape(N, K)


def sm90_shapes(ncfg: NeRFConfig, k0: int, kv: int
                ) -> List[Tuple[int, int]]:
    """(N, K) of each block of the weight image of MLP inputs of k0 and kv
    columns (K1 and K3: `input_widths`; K4: dnet_input and the view
    input), in `layer_shapes` order, each input segment padded to a
    multiple of 64."""
    return mlp_shapes(ncfg, _rup64(k0), _rup64(kv))


def image_slices(ncfg: NeRFConfig, k0: int, kv: int
                 ) -> List[Tuple[int, int, int, int]]:
    """(layer, slice, byte offset, bytes) of every k-slice of the weight
    image of input widths k0 and kv, in the order the producer copies
    them and the consumers read them: layer by layer, each layer's
    slices in k order."""
    out, off = [], 0
    for i, (n, k) in enumerate(sm90_shapes(ncfg, k0, kv)):
        for s in range(k // SLICE_K):
            out.append((i, s, off, 2 * n * SLICE_K))
            off += 2 * n * SLICE_K
    return out


def _pad_segments(ncfg: NeRFConfig, i: int, w: torch.Tensor, k0p: int,
                  kvp: int, k0q: int, kvq: int, fill) -> torch.Tensor:
    """Layer i's (N, K) block with input segments of k0p / kvp columns
    (`layer_shapes`) -> the same with segments of k0q / kvq columns
    (`sm90_shapes`), the new columns set to `fill`."""
    W = ncfg.width
    pad = lambda n: w.new_full((w.shape[0], n), fill)
    if i == 0:
        return torch.cat([w, pad(k0q - k0p)], 1)
    if i < ncfg.depth and (i - 1) in ncfg.skips:
        return torch.cat([w[:, :k0p], pad(k0q - k0p), w[:, k0p:]], 1)
    if i == ncfg.depth + 1:
        return torch.cat([w, pad(kvq - kvp)], 1)
    return w


_IMAGE_INDEX: Dict[Any, torch.Tensor] = {}


def image_index(ncfg: NeRFConfig, k0: int, kv: int, device
                ) -> torch.Tensor:
    """For each element of the weight image of MLP inputs of k0 and kv
    columns (`sm90_shapes`), the index of the same weight in the
    fragment-order 'w' of blocks padded to 16 (`pack_mlp_params`), or
    len('w') for a padding zero (cached per config, widths and device):
    the image is cat([w, 0])[index]."""
    key = (ncfg.width, ncfg.depth, tuple(ncfg.skips), k0, kv, str(device))
    if key not in _IMAGE_INDEX:
        k0p, kvp = _rup16(k0), _rup16(kv)
        n_w = sum(n * k for n, k in mlp_shapes(ncfg, k0p, kvp))
        blocks, off = [], 0
        for i, (n, k) in enumerate(mlp_shapes(ncfg, k0p, kvp)):
            pos = from_fragment_order(torch.arange(off, off + n * k), n, k)
            blocks.append(_pad_segments(ncfg, i, pos, k0p, kvp, _rup64(k0),
                                        _rup64(kv), n_w))
            off += n * k
        _IMAGE_INDEX[key] = torch.cat(
            [to_sm90_image(b) for b in blocks]).to(device)
    return _IMAGE_INDEX[key]


def weights_from_image(ncfg: NeRFConfig, packed: Dict[str, Any]
                       ) -> List[torch.Tensor]:
    """The weight image 'img' (K1's, K3's or K4's) read slice by slice in
    the kernel's order (`image_slices`) and cut back to the 16-padded
    blocks of `mlp_shapes`, as f32 (bf16 values): the same tensors as
    `_weights_f32` reads from 'w'."""
    k0, kv = packed['k0'], packed['kv']
    k0p, kvp, W = packed['k0p'], packed['kvp'], ncfg.width
    shapes = sm90_shapes(ncfg, k0, kv)
    cols: List[List[torch.Tensor]] = [[] for _ in shapes]
    img = packed['img']
    for i, _, off, nbytes in image_slices(ncfg, k0, kv):
        n = shapes[i][0]
        cols[i].append(from_sm90_image(img[off // 2:(off + nbytes) // 2], n,
                                       SLICE_K))
    # the columns of each 16-padded block within its 64-padded block
    k0q, kvq = shapes[0][1], shapes[-1][1] - W
    ws = []
    for i, c in enumerate(cols):
        k16 = mlp_shapes(ncfg, k0p, kvp)[i][1]
        where = _pad_segments(ncfg, i, torch.arange(k16)[None], k0p, kvp,
                              k0q, kvq, -1)[0]
        ws.append(torch.cat(c, 1)[:, where >= 0].float())
    return ws


#: columns of a C tile of K2's products, and the row padding of the
#: segments of its W^T image (csrc/fused_render_bwd_sm90.cu: NB)
BWD_TILE_N = 256


def _rup256(n: int) -> int:
    return -(-n // BWD_TILE_N) * BWD_TILE_N


def t_image_segments(ncfg: NeRFConfig, nfk: int, nfv: int
                     ) -> List[Tuple[int, int, int, int, int]]:
    """(layer, first input row, rows, padded rows, N) of every segment of
    K2's W^T image, in order: each MMA layer's (K, N) transposed block cut
    at its input segments (layer 0 [x0], a skip layer [x0 | h], the other
    trunk layers and the feature layer [h], the view layer [feat | xv]),
    each segment's rows padded to a multiple of 256."""
    _, k0p, _, kvp = input_widths(nfk, nfv)
    W = ncfg.width
    out = []
    for i, (n, _) in enumerate(mlp_shapes(ncfg, k0p, kvp)):
        if i == 0:
            segs = [(0, k0p)]
        elif i < ncfg.depth and (i - 1) in ncfg.skips:
            segs = [(0, k0p), (k0p, W)]
        elif i == ncfg.depth + 1:
            segs = [(0, W), (W, kvp)]
        else:
            segs = [(0, W)]
        out += [(i, r0, rows, _rup256(rows), n) for r0, rows in segs]
    return out


_T_IMAGE_INDEX: Dict[Any, torch.Tensor] = {}


def t_image_index(ncfg: NeRFConfig, nfk: int, nfv: int, device
                  ) -> torch.Tensor:
    """For each element of K2's W^T image, the index of the same weight in
    the fragment-order 'w', or len('w') for a padding zero (cached per
    config and device): the image is cat([w, 0])[index]. Each segment
    (`t_image_segments`) is laid out as `to_sm90_image` lays out a block
    of its padded rows and N columns: 64-deep k-slices over the layer's
    outputs in the K-major 128-byte swizzle, so that a 256-row tile of a
    k-slice is one contiguous 32 KB run."""
    key = (ncfg.width, ncfg.depth, tuple(ncfg.skips), nfk, nfv, str(device))
    if key not in _T_IMAGE_INDEX:
        _, k0p, _, kvp = input_widths(nfk, nfv)
        shapes = mlp_shapes(ncfg, k0p, kvp)
        offs = [0]
        for n, k in shapes:
            offs.append(offs[-1] + n * k)
        parts = []
        for i, r0, rows, rpad, n in t_image_segments(ncfg, nfk, nfv):
            k = shapes[i][1]
            pos = from_fragment_order(torch.arange(offs[i], offs[i + 1]), n,
                                      k).t()
            parts.append(to_sm90_image(torch.cat(
                [pos[r0:r0 + rows], pos.new_full((rpad - rows, n),
                                                 offs[-1])])))
        _T_IMAGE_INDEX[key] = torch.cat(parts).to(device)
    return _T_IMAGE_INDEX[key]


def weights_from_t_image(ncfg: NeRFConfig, packed: Dict[str, Any],
                         img_t: torch.Tensor) -> List[torch.Tensor]:
    """K2's W^T image back to the (N, K) blocks of `layer_shapes`, as f32
    (bf16 values): the same tensors as `_weights_f32` reads from 'w'."""
    blocks: Dict[int, List[torch.Tensor]] = {}
    off = 0
    for i, _, rows, rpad, n in t_image_segments(ncfg, packed['nfk'],
                                                packed['nfv']):
        seg = from_sm90_image(img_t[off:off + rpad * n], rpad, n)[:rows]
        blocks.setdefault(i, []).append(seg)
        off += rpad * n
    return [torch.cat(blocks[i]).t().float() for i in sorted(blocks)]


def act_rows(ncfg: NeRFConfig, nfk: int, nfv: int) -> Dict[str, int]:
    """The feature rows of K2's saved activations (csrc/sm90_common.cuh:
    make_act_rows): x0 and xv each padded to 64 rows, then h_0 ..
    h_{depth-1}, feat and hv; 'F' is the rows of one tile of 64 points."""
    k0, _, kv, _ = input_widths(nfk, nfv)
    W = ncfg.width
    xv = _rup64(k0)
    h = xv + _rup64(kv)
    feat = h + ncfg.depth * W
    return {'x0': 0, 'xv': xv, 'h': h, 'feat': feat, 'hv': feat + W,
            'F': feat + W + W // 2}


def act_image(x: torch.Tensor) -> torch.Tensor:
    """(P, F) features of P points (F a multiple of 8) -> K2's act layout,
    flat: per tile of 64 points (the last one zero-padded), F feature rows
    of 64 points, the 16-byte group h of row f holding points
    8 (h ^ (f % 8)) .. + 7 (`to_sm90_image` with the points as k)."""
    P, F = x.shape
    T = -(-P // SLICE_K)
    tiles = torch.cat([x, x.new_zeros((T * SLICE_K - P, F))])
    return to_sm90_image(tiles.reshape(T, SLICE_K, F).transpose(1, 2)
                         .reshape(T * F, SLICE_K))


def from_act_image(flat: torch.Tensor, P: int, F: int) -> torch.Tensor:
    """Inverse of act_image: the (P, F) features back."""
    T = -(-P // SLICE_K)
    return (from_sm90_image(flat[:T * F * SLICE_K], T * F, SLICE_K)
            .reshape(T, F, SLICE_K).transpose(1, 2).reshape(-1, F)[:P])


def split3_ref(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x -> bf16 (hi, mid, lo) with hi + mid + lo == x exactly, for x
    in the normal range of bf16 with room for the two residuals
    (csrc/fused_render_bwd_sm90.cu: split3): each term rounds what the
    terms before it leave to the nearest bf16, and each residual is exact
    in f32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def split_product_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of K2's split product: a (M, K) f32 times b
    (K, N) holding bf16 values, as the three bf16 planes of a
    (`split3_ref`; lo, mid, hi) each times b, summed in f32."""
    b = b.float()
    hi, mid, lo = split3_ref(a.float())
    return lo.float() @ b + mid.float() @ b + hi.float() @ b


def pack_render_params(params: Dict[str, Any], ncfg: NeRFConfig,
                       n_freq_kp: int, n_freq_view: int,
                       cutoff_dist: torch.Tensor) -> Dict[str, Any]:
    """One network's params -> the kernel's operands.

    'w' is every MMA layer's (N, K) bf16 block in fragment order, in
    `layer_shapes` order; 'img' the same blocks as K1's weight image
    (`sm90_shapes`, gathered from 'w' by `image_index`); 'img_t' K2's W^T
    image of them (`t_image_segments`, gathered by `t_image_index`); 'b'
    the matching f32 biases. The 3-wide rgb and 1-wide alpha heads run on
    the CUDA cores in f32 on bf16-rounded weights ('w_rgb' (3, W/2),
    'w_alpha' (W,), 'b_out' (4,)).
    """
    k0, _, kv, _ = input_widths(n_freq_kp, n_freq_view)
    mlp = pack_mlp_params(params, ncfg, k0, kv)
    w0 = torch.cat([mlp['w'], mlp['w'].new_zeros(1)])
    return {**mlp,
            'img_t': w0[t_image_index(ncfg, n_freq_kp, n_freq_view,
                                      w0.device)],
            'cut': cutoff_dist.reshape(-1)[:N_JOINTS].float()
            .to(cutoff_dist.device).contiguous(),
            'nfk': int(n_freq_kp), 'nfv': int(n_freq_view)}


def pack_mlp_params(params: Dict[str, Any], ncfg: NeRFConfig, k0: int,
                    kv: int) -> Dict[str, Any]:
    """The MLP operands of `pack_render_params` for inputs of k0 (the
    density input: dnet_input columns, and padding) and kv (the view
    input and framecode, and padding) columns: 'w' with blocks padded to
    k0p / kvp (multiples of 16), 'img' the weight image of K1's kernel
    for widths k0 and kv (`image_index`), the biases and the heads. It
    records the four widths."""
    W = ncfg.width
    k0p, kvp = _rup16(k0), _rup16(kv)
    dnet = ncfg.dnet_input

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
    w = torch.cat([to_fragment_order(b.to(bf)) for b in blocks]).contiguous()
    w0 = torch.cat([w, w.new_zeros(1)])
    return {
        'w': w, 'img': w0[image_index(ncfg, k0, kv, w.device)],
        'b': torch.cat(biases).float().contiguous(),
        'w_rgb': params['rgb_linear']['w'].t().to(bf).float().contiguous(),
        'w_alpha': params['alpha_linear']['w'][:, 0].to(bf).float()
        .contiguous(),
        'b_out': torch.cat([params['rgb_linear']['b'],
                            params['alpha_linear']['b']]).float()
        .contiguous(),
        'k0': k0, 'kv': kv, 'k0p': k0p, 'kvp': kvp,
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


def accurate_sincos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PE's sin / cos pair: the accurate library functions, as the
    kernels' sincosf."""
    return torch.sin(x), torch.cos(x)


def geometry(pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's transform in plain fp32: local coordinates pts_t (R, S, 72),
    distances v (R, S, 24) and unit bone directions r (R, S, 72)."""
    R, J = pts.shape[0], N_JOINTS
    pts_t = rotate_flat(pts, m_all.reshape(R, 3, C72)) + aux[:, None, :C72]
    v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_t, J), 1e-24))
    r = pts_t * _expand3(1.0 / torch.clamp_min(v, 1e-12), J)
    return pts_t, v, r


def embed(packed: Dict[str, Any], v: torch.Tensor, r: torch.Tensor,
          d: torch.Tensor, fc: torch.Tensor, tau,
          sincos=accurate_sincos) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' cutoff PE in plain torch: distances v (..., 24), unit
    bone directions r (..., 72), view directions d (..., 72) and
    framecodes fc (..., 16) (d and fc may broadcast over the sample axis)
    -> the bf16-rounded MLP inputs x0 (..., k0p) and xv (..., kvp), as f32
    values."""
    nfk, nfv = packed['nfk'], packed['nfv']
    k0, k0p, kv, kvp = input_widths(nfk, nfv)
    lead, J = v.shape[:-1], N_JOINTS
    w24 = torch.sigmoid(-tau * (v - packed['cut']))        # 1 - sigmoid

    def bands(x, n):        # (..., D) -> (..., 1 + 2n, D): [x, s0, c0, ..]
        f = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
        ang = x[..., None, :] * f[:, None]
        sc = torch.stack(sincos(ang), -2)
        return torch.cat([x[..., None, :],
                          sc.reshape(*x.shape[:-1], 2 * n, x.shape[-1])], -2)

    kp = (bands(v, nfk) * w24[..., None, :]).reshape(*lead, k0 - C72)
    x0 = torch.cat([kp, r, v.new_zeros((*lead, k0p - k0))], -1)
    vb = bands(d, nfv) * _expand3(w24, J)[..., None, :]    # (..., K, 72)
    xv = torch.cat([vb.reshape(*lead, kv - FC_CH),
                    fc.expand(*lead, FC_CH),
                    v.new_zeros((*lead, kvp - kv))], -1)
    bf = torch.bfloat16
    return x0.to(bf).float(), xv.to(bf).float()


def _encode(packed, pts, m_all, aux, S, tau, sincos=accurate_sincos):
    """K1's phase A in plain torch: the bf16-rounded MLP inputs
    x0 (R, S, k0p) and xv (R, S, kvp), as f32 values."""
    _, v, r = geometry(pts, m_all, aux)
    return embed(packed, v, r, aux[:, None, C72:2 * C72],
                 aux[:, None, 2 * C72:], tau, sincos)


def _weights_f32(ncfg: NeRFConfig, packed: Dict[str, Any]
                 ) -> List[torch.Tensor]:
    """Every MMA layer's (N, K) weight block back from fragment order, as
    f32 (bf16 values), in `layer_shapes` order."""
    ws, off = [], 0
    for n, k in mlp_shapes(ncfg, packed['k0p'], packed['kvp']):
        ws.append(from_fragment_order(packed['w'][off:off + n * k], n, k)
                  .float())
        off += n * k
    return ws


def mlp_trace(ncfg: NeRFConfig, packed: Dict[str, Any], x0: torch.Tensor,
              xv: torch.Tensor, ws: List[torch.Tensor] | None = None
              ) -> Dict[str, Any]:
    """The kernels' MLP (phase B) in plain torch, from the bf16-valued
    inputs x0 (..., k0p) and xv (..., kvp): bf16 operands, f32 products
    and accumulation, activations rounded to bf16 between layers. Keeps
    what K2 reads: every trunk activation hs[i], feat and hv (each
    bf16-rounded, as f32), the weights and the raw output. `ws` replaces
    the weights read from 'w' (e.g. `weights_from_image`)."""
    W = ncfg.width
    if ws is None:
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
    return {'hs': hs, 'feat': feat, 'hv': hv, 'ws': ws,
            'out': torch.cat([rgb, alpha], -1)}


def _forward_trace(ncfg: NeRFConfig, packed: Dict[str, Any],
                   pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                   S: int, tau) -> Dict[str, Any]:
    """K1's forward in plain torch, keeping what the backward reads: the
    MLP inputs x0 / xv and everything `mlp_trace` keeps."""
    x0, xv = _encode(packed, pts, m_all, aux, S, tau)
    return {'x0': x0, 'xv': xv, **mlp_trace(ncfg, packed, x0, xv)}


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


def build_raw_inputs(pts: torch.Tensor, rays_d: torch.Tensor,
                     skts: torch.Tensor, framecodes: torch.Tensor | None
                     ) -> torch.Tensor:
    """K3's input from world points: pts (R, S, 3), rays_d (R, 1, 3),
    skts (R, J, 4, 4), framecodes (R, 16) or None -> (R, S, 184) f32
    [v (24) | r (72) | d (72) | fc (16)], the per-joint distances, unit
    bone directions and unit view directions of every point, as JAX's
    build_raw_inputs computes them (without its 128-lane segments)."""
    R, S = pts.shape[:2]
    J = N_JOINTS
    pts_t = transform_batch_pts_flat(pts, skts)             # (R, S, 72)
    v = torch.sqrt(torch.clamp_min(_group3_sumsq(pts_t, J), 0.0))
    r = pts_t * _expand3(1.0 / torch.clamp_min(v, 1e-12), J)
    rays_flat = rotate_flat(rays_d, rot_cols(skts))         # (R, 1, 72)
    dss = _group3_sumsq(rays_flat, J)
    d = rays_flat * _expand3(torch.rsqrt(torch.clamp_min(dss, 1e-24)), J)
    if framecodes is None:
        framecodes = pts.new_zeros((R, FC_CH))
    if framecodes.shape[-1] != FC_CH:
        raise ValueError(f'framecodes must be (R, {FC_CH})')
    return torch.cat([v, r, d.expand(R, S, C72),
                      framecodes[:, None].to(v.dtype).expand(R, S, FC_CH)],
                     -1).float().contiguous()


def fused_encode_mlp_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                         x_raw: torch.Tensor, tau) -> torch.Tensor:
    """The plain PyTorch version of K3: raw inputs (..., 184) -> raw
    (..., 4), the cutoff PE and MLP of K1's plain version."""
    J = N_JOINTS
    x0, xv = embed(packed, x_raw[..., :J], x_raw[..., J:J + C72],
                   x_raw[..., J + C72:J + 2 * C72],
                   x_raw[..., J + 2 * C72:], tau)
    return mlp_trace(ncfg, packed, x0, xv)['out']


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


def pe_transform_bwd_ref(packed, pts, m_all, aux, S, tau, dx0, dxv,
                         pe_only=False):
    """Backward of the cutoff PE and the world->local transform in exact
    fp32 (the pose-refinement path): cotangents of the MLP inputs dx0
    (R, S, k0p) and dxv (R, S, kvp) -> dpts (R, S, 3), dm_all (R*3, 72),
    daux (R, 160). Mirrors K2's last kernel term by term. With `pe_only`
    (K2-d's pe stage) it stops before the transform backward and returns
    the stage's digest (R, S, 3): per point the sums of the distances'
    cotangents dv (window derivative included), of the view directions'
    dd and of the unit bone directions' dr."""
    nfk, nfv = packed['nfk'], packed['nfv']
    R, J = pts.shape[0], N_JOINTS
    m = m_all.reshape(R, 3, C72)
    d = aux[:, C72:2 * C72]
    pts_t, v, _ = geometry(pts, m_all, aux)
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
    if pe_only:
        return torch.stack([dv.sum(-1), dd.sum(-1), drb.sum(-1)], -1)
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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value (ties to even), kept in f32:
    the cotangent operand of K2's products in the bf16 flavour."""
    return x.to(torch.bfloat16).float()


def trace_from_act(ncfg: NeRFConfig, packed: Dict[str, Any],
                   act: torch.Tensor, P: int) -> Dict[str, Any]:
    """K2's saved activations (`launch_bwd`'s 'act', `act_image` layout)
    of P points -> the forward trace `mlp_bwd_ref` reads (x0, xv, hs,
    feat, hv as f32 (P, width) and the weights): the plain backward on
    the kernel's own activations, so that a comparison sees the
    backward's arithmetic and not the two recomputes' roundings."""
    rows = act_rows(ncfg, packed['nfk'], packed['nfv'])
    _, k0p, _, kvp = input_widths(packed['nfk'], packed['nfv'])
    a = from_act_image(act, P, rows['F']).float()
    W = ncfg.width
    return {'x0': a[:, :k0p], 'xv': a[:, rows['xv']:rows['xv'] + kvp],
            'hs': [a[:, rows['h'] + i * W:rows['h'] + (i + 1) * W]
                   for i in range(ncfg.depth)],
            'feat': a[:, rows['feat']:rows['feat'] + W],
            'hv': a[:, rows['hv']:rows['hv'] + W // 2],
            'ws': _weights_f32(ncfg, packed)}


def mlp_bwd_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                S: int, tau, g: torch.Tensor, bwd_f32: bool = True,
                trace: Dict[str, Any] | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's recompute and MLP backward in plain torch (ReLU masks from the
    bf16-rounded activations), for the cotangent g (R, S, 4) of K1's
    output. With bwd_f32 the cotangent products are f32; without it (the
    JAX `bwd_f32=False` flavour) the cotangent operand of every product
    (g in the heads and the alpha head's term, dhv, dfeat, each trunk dh)
    is rounded to bf16 first, the other operand being bf16 already, and
    the sums stay f32. The bias rows are f32 sums of the unrounded
    cotangents in both flavours. Returns (dW flat in `grad_blocks`
    layout, dx0 (R, S, k0p), dxv (R, S, kvp)), the cotangents of the MLP
    inputs. `trace` takes the place of the recompute (`trace_from_act`:
    the kernel's own saved activations)."""
    R = pts.shape[0]
    P = R * S
    t = trace if trace is not None else _forward_trace(
        ncfg, packed, pts, m_all, aux, S, tau)
    ws, hs = t['ws'], t['hs']
    flat = lambda x: x.reshape(P, x.shape[-1])
    x0, xv, feat, hv = (flat(t[k]) for k in ('x0', 'xv', 'feat', 'hv'))
    hs = [flat(h) for h in hs]
    g2 = g.reshape(P, 4).float()
    W, depth = ncfg.width, ncfg.depth
    k0p = x0.shape[-1]
    cot = (lambda x: x) if bwd_f32 else round_bf16

    def block(x, dy):           # (K + 1, N): x^T dy, then the bias row
        return torch.cat([x.t() @ cot(dy), dy.sum(0, keepdim=True)])

    grads = {'rgb': block(hv, g2[:, :3]), 'alpha': block(hs[-1], g2[:, 3:])}
    dhv = (cot(g2[:, :3]) @ packed['w_rgb']) * (hv > 0)
    grads['view'] = block(torch.cat([feat, xv], -1), dhv)
    dview = cot(dhv) @ ws[depth + 1]
    dfeat, dxv = dview[:, :W], dview[:, W:]
    grads['feat'] = block(hs[-1], dfeat)
    dh = (cot(dfeat) @ ws[depth] + cot(g2[:, 3:]) * packed['w_alpha']) \
        * (hs[-1] > 0)
    dx0 = torch.zeros_like(x0)
    for i in range(depth - 1, 0, -1):
        skip = (i - 1) in ncfg.skips
        grads[f'l{i}'] = block(torch.cat([x0, hs[i - 1]], -1) if skip
                               else hs[i - 1], dh)
        din = cot(dh) @ ws[i]
        if skip:
            dx0 = dx0 + din[:, :k0p]
            din = din[:, k0p:]
        dh = din * (hs[i - 1] > 0)
    grads['l0'] = block(x0, dh)
    dx0 = dx0 + cot(dh) @ ws[0]

    dW = torch.cat([grads[nm].reshape(-1) for nm, _, _ in
                    grad_blocks(ncfg, packed['nfk'], packed['nfv'])])
    return dW, dx0.reshape(R, S, k0p), dxv.reshape(R, S, dxv.shape[-1])


def fused_bwd_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                  pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                  S: int, tau, g: torch.Tensor, bwd_f32: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The plain PyTorch version of K2: recompute the forward, then the
    backward with f32 cotangent products (bwd_f32) or bf16 cotangent
    operands (not bwd_f32; `mlp_bwd_ref`), for the cotangent g (R, S, 4)
    of K1's output. ReLU masks come from the bf16-rounded activations;
    the PE and transform backward is f32 in both flavours. Returns (dW
    flat in `grad_blocks` layout, dpts (R, S, 3), dm_all (R*3, 72),
    daux (R, 160))."""
    dW, dx0, dxv = mlp_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g,
                               bwd_f32)
    return (dW,) + pe_transform_bwd_ref(packed, pts, m_all, aux, S, tau,
                                        dx0, dxv)


def build_library(name: str) -> Tuple[Path, str]:
    """Compile one kernel source ('fused_render_sm90' = K1, K1-d, K2's
    recompute, K3 and K4, 'fused_render' = K1-v1, 'fused_render_bwd_sm90'
    = K2 and K2-d after the recompute, 'fused_render_bwd' = K2-v1,
    'fused_render_modes' = K3-v1 and K4-v1) for sm_90a
    into anerf_torch/_build/, once per version of its sources. Returns
    (library path, nvcc's messages, which include ptxas' register and
    spill report)."""
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
        if name == 'fused_render_sm90':
            lib.anerf_fused_encode_mlp_pts_sm90.argtypes = \
                [p] * 10 + [i] * 6 + [f, p]
            lib.anerf_fused_encode_mlp_pts_sm90.restype = i
            lib.anerf_fused_stage_sm90.argtypes = [i] + [p] * 10 + [i] * 6 \
                + [f, p]
            lib.anerf_fused_stage_sm90.restype = i
            lib.anerf_sm90_cluster_size.argtypes = []
            lib.anerf_sm90_cluster_size.restype = i
            lib.anerf_k2_recompute_sm90.argtypes = \
                [p] * 10 + [i] * 6 + [f, p, p]
            lib.anerf_k2_recompute_sm90.restype = i
            lib.anerf_fused_encode_mlp_raw_sm90.argtypes = \
                [p] * 8 + [i] * 5 + [f, p]
            lib.anerf_fused_encode_mlp_raw_sm90.restype = i
            lib.anerf_fused_mlp_sm90.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.anerf_fused_mlp_sm90.restype = i
        elif name == 'fused_render':
            lib.anerf_fused_encode_mlp_pts_v1.argtypes = \
                [p] * 10 + [i] * 6 + [f, p]
            lib.anerf_fused_encode_mlp_pts_v1.restype = i
        elif name == 'fused_render_bwd_sm90':
            lib.anerf_fused_bwd_sm90.argtypes = \
                [i, i] + [p] * 19 + [i] * 7 + [f, p]
            lib.anerf_fused_bwd_sm90.restype = i
            lib.anerf_split_gemm_probe.argtypes = \
                [i, p, i, p, ctypes.c_longlong, i, i, i, i, p, i, i, i,
                 ctypes.c_longlong, p]
            lib.anerf_split_gemm_probe.restype = i
        elif name == 'fused_render_bwd':
            lib.anerf_fused_bwd.argtypes = [p] * 23 + [i] * 7 + [f, p]
            lib.anerf_fused_bwd.restype = i
            lib.anerf_fma_gemm_probe.argtypes = [i, p, i, p, i, i, p, p, i,
                                                 i, p]
            lib.anerf_fma_gemm_probe.restype = i
        else:
            lib.anerf_fused_encode_mlp_raw.argtypes = \
                [p] * 8 + [i] * 5 + [f, p]
            lib.anerf_fused_encode_mlp_raw.restype = i
            lib.anerf_fused_mlp.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.anerf_fused_mlp.restype = i
        lib.anerf_cuda_error_string.argtypes = [i]
        lib.anerf_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_kernel_operands(fn: str, ncfg: NeRFConfig,
                          packed: Dict[str, Any], device: torch.device,
                          n_points: int, **tensors) -> None:
    """Raise unless the config and every operand are what the kernels
    take: width 256, at most 31 trunk layers, point indices within 32
    bits, packed weights of the config's shapes, and each tensor
    (name=(tensor, shape or None, dtype)) contiguous, of its type and
    shape, on `device`, a CUDA device."""
    if device.type != 'cuda':
        raise ValueError(f'{fn}: no kernel for {device}')
    if ncfg.width != KERNEL_WIDTH:
        raise ValueError(f'the kernels are built for width {KERNEL_WIDTH}')
    if ncfg.depth > 31:
        raise ValueError('the kernels take at most 31 trunk layers')
    if 4 * n_points >= 2 ** 31:
        raise ValueError('the kernels index points with 32-bit ints: '
                         f'{n_points} points are too many; split them')
    tensors = {'w': (packed['w'], None, torch.bfloat16),
               'b': (packed['b'], None, torch.float32),
               'w_rgb': (packed['w_rgb'], (3, KERNEL_WIDTH // 2),
                         torch.float32),
               'w_alpha': (packed['w_alpha'], (KERNEL_WIDTH,),
                           torch.float32),
               'b_out': (packed['b_out'], (4,), torch.float32),
               **tensors}
    for name, (t, shape, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f'{fn}: {name} must be a contiguous {dtype} '
                             f'{shape} on {device}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    n_w = sum(n * k for n, k in mlp_shapes(ncfg, packed['k0p'],
                                            packed['kvp']))
    if packed['w'].numel() != n_w:
        raise ValueError('packed weights do not match the config')


def _check_operands(fn: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                    pts: torch.Tensor, m_all: torch.Tensor,
                    aux: torch.Tensor, S: int, **extra) -> None:
    """`check_kernel_operands` for K1-v1's operands (and K2's `extra`)."""
    R = pts.shape[0]
    check_kernel_operands(
        fn, ncfg, packed, pts.device, R * S,
        pts=(pts, (R, S, 3), torch.float32),
        m_all=(m_all, (R * 3, C72), torch.float32),
        aux=(aux, (R, AUX_W), torch.float32),
        cut=(packed['cut'], (N_JOINTS,), torch.float32), **extra)


#: an H100 block's opt-in shared-memory maximum (csrc/sm90_common.cuh:
#: MAX_SMEM)
SM90_MAX_SMEM = 232448
#: weight stages of K1's ring (csrc/fused_render_sm90.cu: STAGES)
SM90_STAGES = 3


def sm90_smem_bytes(k0: int, kv: int) -> int:
    """Shared memory of K1's kernel (and K3's, K4's) for MLP inputs of k0
    and kv columns, as csrc/fused_render_sm90.cu plans it (make_layout,
    smem_bytes_sm90): the X0 region (X0's 64-column chunks, or XV's less
    the activation buffer it spills into), two activation buffers, the
    windows, the head partials, the weight stages and their barriers, and
    the alignment slack."""
    W, TM = KERNEL_WIDTH, 64
    chunk = TM * SLICE_K * 2                  # bytes of a 64 x 64 bf16 chunk
    xr = max(_rup64(k0), _rup64(kv) - W) // SLICE_K
    return ((xr + 2 * W // SLICE_K) * chunk + TM * N_JOINTS * 4
            + 2 * TM * 4 * 4 + SM90_STAGES * W * SLICE_K * 2
            + 2 * SM90_STAGES * 8 + 1024)


def check_sm90_layout(fn: str, k0: int, kv: int) -> None:
    """Raise unless K1's kernel has room in shared memory for MLP inputs
    of k0 and kv columns (`sm90_smem_bytes`): X0 up to 448 columns and XV
    up to 704, the flagship's padded widths."""
    need = sm90_smem_bytes(k0, kv)
    if need > SM90_MAX_SMEM:
        raise ValueError(f'{fn}: MLP inputs of {k0} and {kv} columns need '
                         f'{need} bytes of shared memory, more than the '
                         f'{SM90_MAX_SMEM} of a block')


def skip_mask(ncfg: NeRFConfig) -> int:
    """The kernels' skip bits: bit s set for every skip after layer s."""
    return sum(1 << s for s in ncfg.skips)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f'{fn} launch failed: '
                           + lib.anerf_cuda_error_string(err).decode())


def launch_k1(fn: str, stage: int | None, ncfg: NeRFConfig,
              packed: Dict[str, Any], pts: torch.Tensor, m_all: torch.Tensor,
              aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """Launch K1 (`stage` None) or K1-d stopped after `stage` (ST_* of
    csrc/fused_render_common.cuh) on CUDA tensors; returns raw or the
    stage's digest (R, S, 4). Raises if the kernel cannot launch."""
    check_sm90_layout(fn, packed['k0'], packed['kv'])
    _check_operands(fn, ncfg, packed, pts, m_all, aux, S,
                    img=image_operand(ncfg, packed))
    if aux.data_ptr() % 16 or packed['img'].data_ptr() % 16:
        raise ValueError(f'{fn}: aux and the weight image must be 16-byte '
                         'aligned (the kernel reads them 16 bytes at a time)')
    R = pts.shape[0]
    out = torch.empty((R, S, 4), dtype=torch.float32, device=pts.device)
    if R * S == 0:
        return out
    lib = _library('fused_render_sm90')
    entry, head = ((lib.anerf_fused_encode_mlp_pts_sm90, ()) if stage is None
                   else (lib.anerf_fused_stage_sm90, (stage,)))
    with torch.cuda.device(pts.device):
        err = entry(
            *head, pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['img'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            out.data_ptr(), R * S, S, ncfg.depth, skip_mask(ncfg),
            packed['nfk'], packed['nfv'], float(tau), _stream(pts.device))
    _raise_on(lib, err, fn)
    return out


def image_operand(ncfg: NeRFConfig, packed: Dict[str, Any]):
    """The weight image as `check_kernel_operands` takes it: (tensor, its
    shape for the packed widths, bf16)."""
    n_img = sum(n * k for n, k in sm90_shapes(ncfg, packed['k0'],
                                              packed['kv']))
    return packed['img'], (n_img,), torch.bfloat16


def cluster_size() -> int:
    """CTAs per cluster of K1 (csrc/fused_render_sm90.cu: CL)."""
    return _library('fused_render_sm90').anerf_sm90_cluster_size()


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
    out = launch_k1('fused_encode_mlp_pts', None, ncfg, packed, pts, m_all,
                    aux, S, tau)
    if out.numel():
        LAUNCHES += 1
    return out


def fused_encode_mlp_pts_v1(ncfg: NeRFConfig, packed: Dict[str, Any],
                            pts: torch.Tensor, m_all: torch.Tensor,
                            aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """K1-v1, K1's first (mma.sync) kernel, on the same operands: the
    comparison chip_smoke.py measures K1 against. No path of the port
    calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global V1_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau)
    _check_operands('fused_encode_mlp_pts_v1', ncfg, packed, pts, m_all,
                    aux, S)
    R = pts.shape[0]
    out = torch.empty((R, S, 4), dtype=torch.float32, device=pts.device)
    if R * S == 0:
        return out
    lib = _library('fused_render')
    with torch.cuda.device(pts.device):
        err = lib.anerf_fused_encode_mlp_pts_v1(
            pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['w'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            out.data_ptr(), R * S, S, ncfg.depth, skip_mask(ncfg),
            packed['nfk'], packed['nfv'], float(tau), _stream(pts.device))
    _raise_on(lib, err, 'fused_encode_mlp_pts_v1')
    V1_LAUNCHES += 1
    return out


def _launch_k3(fn: str, ncfg: NeRFConfig, packed: Dict[str, Any],
               x_raw: torch.Tensor, tau, v1: bool) -> torch.Tensor:
    """Launch K3 (K1's kernel in its IN_RAW mode, on the weight image) or
    K3-v1 (K1-v1's body, on 'w') on CUDA tensors. Raises if the kernel
    cannot launch."""
    lead = x_raw.shape[:-1]
    P = x_raw[..., 0].numel()
    if not v1:
        check_sm90_layout(fn, packed['k0'], packed['kv'])
    check_kernel_operands(
        fn, ncfg, packed, x_raw.device, P,
        x_raw=(x_raw, (*lead, RAW_W), torch.float32),
        cut=(packed['cut'], (N_JOINTS,), torch.float32),
        **({} if v1 else {'img': image_operand(ncfg, packed)}))
    if not v1 and (x_raw.data_ptr() % 16 or packed['img'].data_ptr() % 16):
        raise ValueError(f'{fn}: x_raw and the weight image must be 16-byte '
                         'aligned (the kernel reads them 16 bytes at a time)')
    out = torch.empty((*lead, 4), dtype=torch.float32, device=x_raw.device)
    if P == 0:
        return out
    lib = _library('fused_render_modes' if v1 else 'fused_render_sm90')
    entry = (lib.anerf_fused_encode_mlp_raw if v1
             else lib.anerf_fused_encode_mlp_raw_sm90)
    with torch.cuda.device(x_raw.device):
        err = entry(
            x_raw.data_ptr(), packed['w' if v1 else 'img'].data_ptr(),
            packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
            packed['cut'].data_ptr(), out.data_ptr(), P, ncfg.depth,
            skip_mask(ncfg), packed['nfk'], packed['nfv'], float(tau),
            _stream(x_raw.device))
    _raise_on(lib, err, fn)
    return out


def fused_encode_mlp(ncfg: NeRFConfig, packed: Dict[str, Any],
                     x_raw: torch.Tensor, tau) -> torch.Tensor:
    """K3: raw inputs (..., 184) from `build_raw_inputs` -> raw (..., 4):
    cutoff PE + MLP, with K1's operands from `pack_render_params`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global RAW_LAUNCHES
    if x_raw.device.type == 'cpu':
        return fused_encode_mlp_ref(ncfg, packed, x_raw, tau)
    out = _launch_k3('fused_encode_mlp', ncfg, packed, x_raw, tau, False)
    if out.numel():
        RAW_LAUNCHES += 1
    return out


def fused_encode_mlp_v1(ncfg: NeRFConfig, packed: Dict[str, Any],
                        x_raw: torch.Tensor, tau) -> torch.Tensor:
    """K3-v1, K3's first (mma.sync) kernel, on the same operands: the
    comparison chip_smoke.py measures K3 against. No path of the port
    calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global RAW_V1_LAUNCHES
    if x_raw.device.type == 'cpu':
        return fused_encode_mlp_ref(ncfg, packed, x_raw, tau)
    out = _launch_k3('fused_encode_mlp_v1', ncfg, packed, x_raw, tau, True)
    if out.numel():
        RAW_V1_LAUNCHES += 1
    return out


def _bwd_scratch(ncfg: NeRFConfig, packed: Dict[str, Any], P: int,
                 dev) -> Dict[str, torch.Tensor]:
    """K2's and K2-v1's f32 cotangent buffers and per-chunk dW partials."""
    _, k0p, _, kvp = input_widths(packed['nfk'], packed['nfv'])
    W, WV = ncfg.width, ncfg.width // 2
    n_grad = sum(r * c for _, r, c in grad_blocks(ncfg, packed['nfk'],
                                                  packed['nfv']))
    f32 = dict(dtype=torch.float32, device=dev)
    return {'dhv': torch.empty((P, WV), **f32),           # d hv
            'dview': torch.empty((P, W + kvp), **f32),    # d [feat | xv]
            'dh_a': torch.empty((P, W), **f32),           # d h, ping
            'dh_b': torch.empty((P, W), **f32),           # d h, pong
            'dx0': torch.empty((P, k0p), **f32),          # d x0
            'partial': torch.empty((-(-P // BWD_CHUNK), n_grad), **f32)}


def _bwd_outputs(ncfg: NeRFConfig, packed: Dict[str, Any], R: int, S: int,
                 dev) -> Dict[str, torch.Tensor]:
    n_grad = sum(r * c for _, r, c in grad_blocks(ncfg, packed['nfk'],
                                                  packed['nfv']))
    f32 = dict(dtype=torch.float32, device=dev)
    return {'dW': torch.zeros((n_grad,), **f32),
            'dpts': torch.zeros((R, S, 3), **f32),
            'dm': torch.zeros((R * 3, C72), **f32),
            'daux': torch.zeros((R, AUX_W), **f32)}


def launch_bwd(stage: int, ncfg: NeRFConfig, packed: Dict[str, Any],
               pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
               S: int, tau, g: torch.Tensor, bwd_f32: bool = True
               ) -> Dict[str, torch.Tensor]:
    """Launch K2's sequence on CUDA tensors, stopped after `stage` (K2-d's
    codes, kernels/stages.py: 0 full, 1 recompute, 2 mlp, 3 pe): K1's
    kernel with SAVE (csrc/fused_render_sm90.cu), then the layer launches
    of csrc/fused_render_bwd_sm90.cu, whose cotangent products are
    f32-accurate (bwd_f32: three bf16 planes of each f32 cotangent) or
    take the cotangent rounded to bf16 (not bwd_f32: its hi plane alone,
    the JAX `bwd_f32=False` flavour). Allocates the
    outputs and the scratch and returns them by name: dW, dpts, dm, daux,
    act (the saved bf16 activations in `act_image` layout, 2 F bytes a
    point, 7,168 at the flagship, and one spare tile), raw, and the f32
    cotangents dhv, dview, dh_a, dh_b, dx0 and the per-chunk dW partial
    sums."""
    R = pts.shape[0]
    nfk, nfv = packed['nfk'], packed['nfv']
    n_img_t = sum(rpad * n for *_, rpad, n in t_image_segments(ncfg, nfk,
                                                               nfv))
    check_sm90_layout('fused_bwd', packed['k0'], packed['kv'])
    _check_operands('fused_bwd', ncfg, packed, pts, m_all, aux, S,
                    g=(g, (R, S, 4), torch.float32),
                    img=image_operand(ncfg, packed),
                    img_t=(packed['img_t'], (n_img_t,), torch.bfloat16))
    if aux.data_ptr() % 16 or packed['img'].data_ptr() % 16 \
            or packed['img_t'].data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError('fused_bwd: aux, g and the weight images must be '
                         '16-byte aligned')
    P, dev = R * S, pts.device
    t = _bwd_outputs(ncfg, packed, R, S, dev)
    if P == 0:
        return t
    F = act_rows(ncfg, nfk, nfv)['F']
    t['act'] = torch.empty(((-(-P // SLICE_K) + 1) * F * SLICE_K,),
                           dtype=torch.bfloat16, device=dev)
    t['raw'] = torch.empty((P, 4), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    lib = _library('fused_render_sm90')
    with torch.cuda.device(dev):
        err = lib.anerf_k2_recompute_sm90(
            pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['img'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            t['raw'].data_ptr(), P, S, ncfg.depth, skip_mask(ncfg), nfk,
            nfv, float(tau), t['act'].data_ptr(), stream)
    _raise_on(lib, err, 'fused_bwd (recompute)')
    if stage == 1:
        return t
    scratch = _bwd_scratch(ncfg, packed, P, dev)
    t.update(scratch)
    lib = _library('fused_render_bwd_sm90')
    with torch.cuda.device(dev):
        err = lib.anerf_fused_bwd_sm90(
            stage, int(bwd_f32), pts.data_ptr(), m_all.data_ptr(),
            aux.data_ptr(),
            packed['cut'].data_ptr(), packed['img_t'].data_ptr(),
            t['act'].data_ptr(),
            g.data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(),
            *(x.data_ptr() for x in scratch.values()),
            t['dW'].data_ptr(), t['dpts'].data_ptr(), t['dm'].data_ptr(),
            t['daux'].data_ptr(), P, S, ncfg.depth, skip_mask(ncfg), nfk,
            nfv, BWD_CHUNK, float(tau), stream)
    _raise_on(lib, err, 'fused_bwd')
    return t


def fused_bwd(ncfg: NeRFConfig, packed: Dict[str, Any], pts: torch.Tensor,
              m_all: torch.Tensor, aux: torch.Tensor, S: int, tau,
              g: torch.Tensor, bwd_f32: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """K2: the backward of K1 for the cotangent g (R, S, 4) of its output,
    with f32 cotangent products (bwd_f32) or bf16 cotangent operands (not
    bwd_f32, the --fast_grads numerics). Returns (dW flat in
    `grad_blocks` layout, dpts (R, S, 3), dm_all (R*3, 72),
    daux (R, 160)), all f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    sequence (`launch_bwd`; it raises if a kernel cannot launch)."""
    global BWD_LAUNCHES, BWD_BF16_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g,
                             bwd_f32)
    t = launch_bwd(0, ncfg, packed, pts, m_all, aux, S, tau, g, bwd_f32)
    if pts.shape[0] * S:
        if bwd_f32:
            BWD_LAUNCHES += 1
        else:
            BWD_BF16_LAUNCHES += 1
    return t['dW'], t['dpts'], t['dm'], t['daux']


def fused_bwd_v1(ncfg: NeRFConfig, packed: Dict[str, Any],
                 pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                 S: int, tau, g: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """K2-v1, K2's first kernel sequence (K1-v1's body saving activations,
    f32 FMA GEMMs, csrc/fused_render_bwd.cu), on the same operands and
    with the same outputs: the comparison chip_smoke.py measures K2
    against. No path of the port calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    sequence (and raise if it cannot launch)."""
    global BWD_V1_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g)
    R = pts.shape[0]
    _check_operands('fused_bwd_v1', ncfg, packed, pts, m_all, aux, S,
                    g=(g, (R, S, 4), torch.float32))
    _, k0p, _, kvp = input_widths(packed['nfk'], packed['nfv'])
    W, P, dev = ncfg.width, R * S, pts.device
    t = _bwd_outputs(ncfg, packed, R, S, dev)
    if P == 0:
        return t['dW'], t['dpts'], t['dm'], t['daux']
    w32 = torch.cat([w.reshape(-1) for w in _weights_f32(ncfg, packed)])
    act = torch.empty((P, k0p + kvp + (ncfg.depth + 1) * W + W // 2),
                      dtype=torch.bfloat16, device=dev)
    scratch = {'raw': torch.empty((P, 4), dtype=torch.float32, device=dev),
               **_bwd_scratch(ncfg, packed, P, dev)}
    lib = _library('fused_render_bwd')
    with torch.cuda.device(dev):
        err = lib.anerf_fused_bwd(
            pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['w'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            w32.data_ptr(), g.data_ptr(), act.data_ptr(),
            *(x.data_ptr() for x in scratch.values()),
            t['dW'].data_ptr(), t['dpts'].data_ptr(), t['dm'].data_ptr(),
            t['daux'].data_ptr(), P, S, ncfg.depth, skip_mask(ncfg),
            packed['nfk'], packed['nfv'], BWD_CHUNK, float(tau),
            _stream(dev))
    _raise_on(lib, err, 'fused_bwd_v1')
    BWD_V1_LAUNCHES += 1
    return t['dW'], t['dpts'], t['dm'], t['daux']


def split_gemm_probe(kind: str, dy: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """One of K2's split products alone, the way K2's layer launches run
    it, for the tests and chip_smoke.py: 'dx': dy (P, N) f32 times b
    (N, K), weights holding bf16 values -> (P, K); 'dw': b (P, K),
    activations holding bf16 values, transposed times dy -> (K + 1, N),
    the last row the column sums of dy (the bias gradient), with the
    kernel's per-chunk partial sums added in chunk order. N is a multiple
    of 64.

    CPU tensors take the plain version (`split_product_ref`); CUDA
    tensors launch the kernel (and raise if it cannot launch)."""
    if kind not in ('dx', 'dw'):
        raise ValueError(f'split_gemm_probe: unknown kind {kind!r}')
    P, N = dy.shape
    K = b.shape[1]
    if dy.device.type == 'cpu':
        if kind == 'dx':
            return split_product_ref(dy, b)
        return torch.cat([split_product_ref(dy.t(), b).t(),
                          dy.sum(0, keepdim=True)])
    if N % SLICE_K or dy.dtype != torch.float32 or not dy.is_contiguous():
        raise ValueError('split_gemm_probe: dy must be a contiguous f32 '
                         '(P, N) with N a multiple of 64')
    bf, Kp = torch.bfloat16, _rup256(K)
    f32 = dict(dtype=torch.float32, device=dy.device)
    lib = _library('fused_render_bwd_sm90')
    if kind == 'dx':
        img = to_sm90_image(torch.cat([b.t(), b.new_zeros((Kp - K, N))])
                            .to(bf).contiguous())
        out = torch.empty((P, K), **f32)
        args = (0, dy.data_ptr(), N, img.data_ptr(), Kp * SLICE_K,
                N // SLICE_K, 1, Kp // BWD_TILE_N, K, out.data_ptr(), K, P,
                BWD_CHUNK, 0)
    else:
        img = act_image(torch.cat([b, b.new_zeros((P, Kp - K))], 1).to(bf))
        out = torch.empty((-(-P // BWD_CHUNK), K + 1, N), **f32)
        args = (1, dy.data_ptr(), N, img.data_ptr(), Kp * SLICE_K, 0,
                N // SLICE_K, Kp // BWD_TILE_N, K, out.data_ptr(), N, P,
                BWD_CHUNK, (K + 1) * N)
    with torch.cuda.device(dy.device):
        err = lib.anerf_split_gemm_probe(*args, _stream(dy.device))
    _raise_on(lib, err, 'split_gemm_probe')
    if kind == 'dx':
        return out
    total = out[0].clone()
    for c in range(1, out.shape[0]):
        total += out[c]
    return total


def fma_gemm_probe(kind: str, dy: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """`split_gemm_probe`'s products through K2-v1's f32 FMA GEMM (the
    accuracy chip_smoke.py holds the split products to): 'dx' dy (P, N)
    times b (N, K) -> (P, K); 'dw' b (P, K) transposed times dy, then the
    column sums of dy -> (K + 1, N).

    CPU tensors take the plain version (f32 products); CUDA tensors
    launch the kernel (and raise if it cannot launch)."""
    if kind not in ('dx', 'dw'):
        raise ValueError(f'fma_gemm_probe: unknown kind {kind!r}')
    P, N = dy.shape
    K = b.shape[1]
    if dy.device.type == 'cpu':
        if kind == 'dx':
            return dy @ b.float()
        return torch.cat([b.float().t() @ dy, dy.sum(0, keepdim=True)])
    f32 = dict(dtype=torch.float32, device=dy.device)
    lib = _library('fused_render_bwd')
    if kind == 'dx':
        bb, out, part = b.float().contiguous(), torch.empty((P, K), **f32), \
            None
        args = (0, dy.data_ptr(), N, bb.data_ptr(), N, K, out.data_ptr(),
                None, P, BWD_CHUNK)
    else:
        bb = b.to(torch.bfloat16).contiguous()
        out = torch.empty((K + 1, N), **f32)
        part = torch.empty((-(-P // BWD_CHUNK), (K + 1) * N), **f32)
        args = (1, dy.data_ptr(), N, bb.data_ptr(), K, N, out.data_ptr(),
                part.data_ptr(), P, BWD_CHUNK)
    with torch.cuda.device(dy.device):
        err = lib.anerf_fma_gemm_probe(*args, _stream(dy.device))
    _raise_on(lib, err, 'fma_gemm_probe')
    return out


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


def mesh_averaged_leaves(ncfg: NeRFConfig, params: Dict[str, Any]
                         ) -> List[torch.Tensor]:
    """The leaves of render params whose whole gradient FusedApply's
    backward gives, already averaged over a data-parallel mesh: every
    weight and bias of the coarse and the fine network (a data-parallel
    step leaves them out of its own all-reduce)."""
    return [x for name in ('coarse', 'fine') if name in params
            for x in _net_leaves(ncfg, params[name])]


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
    trained; tau is a schedule); bwd_f32 picks K2's flavour. With a
    data-parallel `mesh` (each rank's points a block of one batch) the
    ranks' K2 weight gradients are averaged before their bf16 rounding,
    as JAX's partitioner sums them over the sharded batch before the
    VJP's cast; this is the only average those leaves get
    (mesh_averaged_leaves)."""

    @staticmethod
    def forward(ctx, ncfg, S, tau, nfk, nfv, bwd_f32, mesh, cutoff_dist,
                pts, m_all, aux, *leaves):
        packed = pack_render_params(_net_from_leaves(ncfg, leaves), ncfg,
                                    nfk, nfv, cutoff_dist)
        ctx.save_for_backward(pts, m_all, aux)
        ctx.packed, ctx.ncfg, ctx.S, ctx.tau = packed, ncfg, S, tau
        ctx.bwd_f32, ctx.mesh = bwd_f32, mesh
        return fused_encode_mlp_pts(ncfg, packed, pts, m_all, aux, S, tau)

    @staticmethod
    def backward(ctx, g):
        pts, m_all, aux = ctx.saved_tensors
        p = ctx.packed
        dW, dpts, dm, daux = fused_bwd(ctx.ncfg, p, pts, m_all, aux, ctx.S,
                                       ctx.tau, g.contiguous().float(),
                                       ctx.bwd_f32)
        if ctx.mesh is not None:
            from ..parallel.mesh import all_reduce_mean
            dW = all_reduce_mean(ctx.mesh, dW)
        return (None,) * 8 + (dpts, dm, daux) + tuple(
            _leaf_grads(ctx.ncfg, p['nfk'], p['nfv'], dW))


def fused_apply(ncfg: NeRFConfig, S: int, net: Dict[str, Any],
                cutoff_dist: torch.Tensor, n_freq_kp: int, n_freq_view: int,
                pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                tau, bwd_f32: bool = True, mesh=None) -> torch.Tensor:
    """Differentiable fused transform + PE + MLP: (R, S, 3) world points
    -> raw (R, S, 4) through K1, with K2 as its backward: f32 cotangent
    products with bwd_f32, bf16 cotangent operands without (the JAX
    `fused_apply`'s bwd_f32; the forward is the same). Gradients reach
    the leaves of `net` (one network's params), pts, m_all and aux.
    mesh: data parallel (FusedApply)."""
    return FusedApply.apply(ncfg, S, float(tau), int(n_freq_kp),
                            int(n_freq_view), bool(bwd_f32), mesh,
                            cutoff_dist, pts, m_all, aux,
                            *_net_leaves(ncfg, net))
