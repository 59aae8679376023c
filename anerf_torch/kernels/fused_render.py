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
--fast_grads numerics) a layer kernel of its own multiplies the
cotangents rounded to bf16, which it keeps in HBM as bf16 tiles of the
saved activations' layout, and the heads round g the same way; its grid
comes from P (`bwd_plan`). The weights' second image 'W^T'
(`t_image_index`) and the saved activations' tile layout (`act_image`)
feed them. K2-v1 (`fused_bwd_v1`,
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

Routes (`route_plan`): the gate (`fused_render_supported`) is JAX's, so
the kernels take any trunk width that is a multiple of 256, any depth,
skip placement and framecode width. K1, K3, K4 and K2's recompute run K1's
single kernel with three weight stages where its tile, activation
buffers and stages fit in a block's shared memory (the flagship), with
two where only two do (e.g. multires 10 with multires_views 4; there K4
takes the layered route, the faster for it), and otherwise the layered route
(csrc/fused_render_layered_sm90.cu: phase A, one persistent, TMA-fed
wgmma GEMM launch per MMA layer through HBM, the heads;
`layered_plan`): a trunk wider than 256, or MLP inputs wider than two
stages leave room for. K2's
layer launches take any width: a DX CTA keeps W^T resident where its
k-slices fit in the stages and walks them through the ring otherwise.
The first versions (K1-v1 .. K4-v1) stay comparisons at the flagship's
family only (`_check_v1`).

Each source is built with nvcc for sm_90a on first use into
anerf_torch/_build/ and loaded with ctypes. A wrapper launches its kernel
for CUDA tensors and runs the plain PyTorch version (`*_ref`) for CPU
tensors; it never falls back from one to the other.

Layouts (no TPU lane padding; fc is the framecode columns, `fc_width`:
the config's framecode width, or 16 zero columns without framecodes):
  pts    (R, S, 3) f32 world points;
  m_all  (R*3, 72) f32 rotation columns, m_all[3r+b, 3j+a] = skts[r,j,a,b];
  aux    (R, 144 + fc) f32 per-ray [trans (72) | unit view dirs (72) | fc]
         (160 at the flagship);
  x_raw  (..., raw_width(fc)) f32 per-point [v (24) | r (72) | d (72) |
         fc | zero pad to a multiple of 4] (K3's input, 184 at the
         flagship; the TPU kernel's is 512 lanes, four 128-lane
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
import dataclasses
import functools
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
from ..utils import trace

N_JOINTS = 24
C72 = 3 * N_JOINTS
#: framecode columns of the view block of a net without framecodes (zeros,
#: as JAX's pack_ray_data fills them) and of the flagship's; a net with
#: framecodes takes its own width (`fc_width`)
FC_CH = 16
AUX_W = 2 * C72 + FC_CH       # the flagship's aux row (`aux_width`)
RAW_W = N_JOINTS + 2 * C72 + FC_CH   # the flagship's K3 row (`raw_width`)
#: trunk width of K1's single kernel (csrc/fused_render_common.cuh: W);
#: other widths take the layered route (`route_plan`)
KERNEL_WIDTH = 256
#: the TPU's lane width, in which JAX's gate states its widths
LANE = 128

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
#: calls that took the layered route (csrc/fused_render_layered_sm90.cu)
#: since the last reset, by kernel: K1 ('k1'), K3 ('k3'), K4 ('k4') and
#: K2's recompute ('k2'). Each call also counts in its kernel's counter
#: above (fused_mlp.LAUNCHES for K4), whatever its route.
LAYERED_LAUNCHES = {'k1': 0, 'k3': 0, 'k4': 0, 'k2': 0}
#: Points per partial sum of K2's weight gradients (one CTA row of the
#: dW products per chunk, reduced afterwards in chunk order).
BWD_CHUNK = 2048

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = {'fused_render_sm90': ('fused_render_sm90.cu', 'sm90_common.cuh',
                                  'fused_render_common.cuh'),
            'fused_render_layered_sm90': ('fused_render_layered_sm90.cu',
                                          'sm90_common.cuh',
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


def fc_width(ncfg: NeRFConfig) -> int:
    """Framecode columns of the kernels' view block: the config's
    framecode width, or FC_CH zero columns for a net without one."""
    return ncfg.framecode_ch if ncfg.use_framecode else FC_CH


def aux_width(fc: int) -> int:
    """Floats of a ray's aux row: trans (72) | unit view dirs (72) | fc."""
    return 2 * C72 + fc


def raw_width(fc: int) -> int:
    """Floats of a K3 input row, v (24) | r (72) | d (72) | fc | zero pad
    to a multiple of 4, so that every row starts 16 bytes aligned."""
    return -(-(N_JOINTS + 2 * C72 + fc) // 4) * 4


def fused_render_supported(rcfg) -> bool:
    """Static check that the RenderConfig matches the kernel family: the
    JAX gate, condition for condition (any trunk width that is a multiple
    of 256, any depth, skip placement and framecode width; the kernels'
    own limits pick a route, `route_plan`, and never refuse)."""
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
        and ncfg.width % LANE == 0 and (ncfg.width // 2) % LANE == 0
    )


def input_widths(nfk: int, nfv: int, fc: int = FC_CH
                 ) -> Tuple[int, int, int, int]:
    """(k0, k0p, kv, kvp): kp+bone input width and the view-block width
    (view PE + fc framecode columns), each with its 16-padded size."""
    k0 = N_JOINTS * (1 + 2 * nfk) + C72
    kv = C72 * (1 + 2 * nfv) + fc
    return k0, _rup16(k0), kv, _rup16(kv)


def layer_shapes(ncfg: NeRFConfig, nfk: int, nfv: int
                 ) -> List[Tuple[int, int]]:
    """(N, K) of each packed weight block, in the order the kernel walks
    the flat buffer: trunk layers, feature layer, view layer."""
    _, k0p, _, kvp = input_widths(nfk, nfv, fc_width(ncfg))
    return mlp_shapes(ncfg, k0p, kvp)


def skip_flags(ncfg: NeRFConfig) -> List[int]:
    """The kernels' per-layer skip flags: 1 where trunk layer i takes
    [x0 | h] (a skip after layer i - 1), for every layer (no depth
    limit; a skip after the last layer feeds none)."""
    return [int(i > 0 and (i - 1) in ncfg.skips) for i in range(ncfg.depth)]


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
    _, k0p, _, kvp = input_widths(nfk, nfv, fc_width(ncfg))
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
    fc = fc_width(ncfg)
    key = (ncfg.width, ncfg.depth, tuple(ncfg.skips), nfk, nfv, fc,
           str(device))
    if key not in _T_IMAGE_INDEX:
        _, k0p, _, kvp = input_widths(nfk, nfv, fc)
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


@functools.lru_cache(maxsize=None)
def _t_image_numel(ncfg: NeRFConfig, nfk: int, nfv: int) -> int:
    """Elements of K2's W^T image."""
    return sum(rpad * n for *_, rpad, n in t_image_segments(ncfg, nfk, nfv))


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
    k0, _, kv, _ = input_widths(nfk, nfv, fc_width(ncfg))
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
    'w_alpha' (W,), 'b_out' (4,)). 'fc' is the framecode columns of the
    view block (`fc_width`), 'skip' the per-layer skip flags.
    """
    with trace.span('anerf.fused.pack'):
        fc = fc_width(ncfg)
        k0, _, kv, _ = input_widths(n_freq_kp, n_freq_view, fc)
        mlp = pack_mlp_params(params, ncfg, k0, kv)
        w0 = torch.cat([mlp['w'], mlp['w'].new_zeros(1)])
        return {**mlp,
                'img_t': w0[t_image_index(ncfg, n_freq_kp, n_freq_view,
                                          w0.device)],
                'cut': cutoff_dist.reshape(-1)[:N_JOINTS].float()
                .to(cutoff_dist.device).contiguous(),
                'nfk': int(n_freq_kp), 'nfv': int(n_freq_view), 'fc': fc}


_SKIP_FLAGS: Dict[Any, torch.Tensor] = {}


def skip_operand(ncfg: NeRFConfig, device) -> torch.Tensor:
    """`skip_flags` as the int32 tensor K1's single kernel reads on the
    device (cached per config and device: no copy per call)."""
    key = (ncfg.depth, tuple(ncfg.skips), str(device))
    if key not in _SKIP_FLAGS:
        _SKIP_FLAGS[key] = torch.tensor(skip_flags(ncfg), dtype=torch.int32,
                                        device=device)
    return _SKIP_FLAGS[key]


def pack_mlp_params(params: Dict[str, Any], ncfg: NeRFConfig, k0: int,
                    kv: int) -> Dict[str, Any]:
    """The MLP operands of `pack_render_params` for inputs of k0 (the
    density input: dnet_input columns, and padding) and kv (the view
    input and framecode, and padding) columns: 'w' with blocks padded to
    k0p / kvp (multiples of 16), 'img' the weight image of K1's kernel
    for widths k0 and kv (`image_index`), the biases, the heads and the
    per-layer skip flags 'skip' (`skip_operand`). It records the four
    widths."""
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
        'skip': skip_operand(ncfg, w.device),
    }


def pack_ray_data(rays_d: torch.Tensor, skts: torch.Tensor,
                  framecodes: torch.Tensor | None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray kernel operands: rays_d (R, 1, 3), skts (R, J, 4, 4),
    framecodes (R, fc) or None (FC_CH zero columns) -> m_all (R*3, 72),
    aux (R, 144 + fc)."""
    R, J = skts.shape[0], skts.shape[1]
    cols = rot_cols(skts)                                  # (R, 3, 72)
    trans = skts[..., :3, 3].reshape(R, J * 3)
    rays_flat = rotate_flat(rays_d, cols)[:, 0]            # (R, 72)
    dss = _group3_sumsq(rays_flat, J)
    d = rays_flat * _expand3(torch.rsqrt(torch.clamp_min(dss, 1e-24)), J)
    if framecodes is None:
        framecodes = rays_flat.new_zeros((R, FC_CH))
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
    framecodes fc (..., packed['fc']) (d and fc may broadcast over the
    sample axis) -> the bf16-rounded MLP inputs x0 (..., k0p) and
    xv (..., kvp), as f32 values."""
    nfk, nfv, nfc = packed['nfk'], packed['nfv'], packed['fc']
    k0, k0p, kv, kvp = input_widths(nfk, nfv, nfc)
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
    xv = torch.cat([vb.reshape(*lead, kv - nfc),
                    fc.expand(*lead, nfc),
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
    skts (R, J, 4, 4), framecodes (R, fc) or None (FC_CH zero columns)
    -> (R, S, raw_width(fc)) f32 [v (24) | r (72) | d (72) | fc | zero
    pad], the per-joint distances, unit bone directions and unit view
    directions of every point, as JAX's build_raw_inputs computes them
    (without its 128-lane segments)."""
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
    fc = framecodes.shape[-1]
    pad = raw_width(fc) - (J + 2 * C72 + fc)
    return torch.cat([v, r, d.expand(R, S, C72),
                      framecodes[:, None].to(v.dtype).expand(R, S, fc),
                      v.new_zeros((R, S, pad))], -1).float().contiguous()


def fused_encode_mlp_ref(ncfg: NeRFConfig, packed: Dict[str, Any],
                         x_raw: torch.Tensor, tau) -> torch.Tensor:
    """The plain PyTorch version of K3: raw inputs (..., raw_width(fc))
    -> raw (..., 4), the cutoff PE and MLP of K1's plain version."""
    J, fc = N_JOINTS, packed['fc']
    x0, xv = embed(packed, x_raw[..., :J], x_raw[..., J:J + C72],
                   x_raw[..., J + C72:J + 2 * C72],
                   x_raw[..., J + 2 * C72:J + 2 * C72 + fc], tau)
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
    daux (R, 144 + fc). Mirrors K2's last kernel term by term. With `pe_only`
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
                      dxv[..., fc0:fc0 + packed['fc']].sum(1)], -1)
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
    _, k0p, _, kvp = input_widths(packed['nfk'], packed['nfv'],
                                  packed['fc'])
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
    daux (R, 144 + fc))."""
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
            # (stages or stage, operands, P, S, depth, skip, nfk, nfv, fc,
            # tau, [act,] stream)
            k1 = [i] + [p] * 10 + [i] * 3 + [p] + [i] * 3 + [f]
            lib.anerf_fused_encode_mlp_pts_sm90.argtypes = k1 + [p]
            lib.anerf_fused_encode_mlp_pts_sm90.restype = i
            lib.anerf_fused_stage_sm90.argtypes = k1 + [p]
            lib.anerf_fused_stage_sm90.restype = i
            lib.anerf_sm90_cluster_size.argtypes = []
            lib.anerf_sm90_cluster_size.restype = i
            lib.anerf_k2_recompute_sm90.argtypes = k1 + [p, p]
            lib.anerf_k2_recompute_sm90.restype = i
            lib.anerf_fused_encode_mlp_raw_sm90.argtypes = \
                [i] + [p] * 8 + [i] * 2 + [p] + [i] * 3 + [f, p]
            lib.anerf_fused_encode_mlp_raw_sm90.restype = i
            lib.anerf_fused_mlp_sm90.argtypes = \
                [i] + [p] * 8 + [i] * 2 + [p] + [i] * 2 + [p]
            lib.anerf_fused_mlp_sm90.restype = i
        elif name == 'fused_render_layered_sm90':
            lib.anerf_layered_forward.argtypes = \
                [i] + [p] * 10 + [i] * 4 + [p] + [i] * 3 + [f, p, i, p, p]
            lib.anerf_layered_forward.restype = i
            lib.anerf_layered_columns.argtypes = [i] * 7
            lib.anerf_layered_columns.restype = i
        elif name == 'fused_render':
            lib.anerf_fused_encode_mlp_pts_v1.argtypes = \
                [p] * 10 + [i] * 6 + [f, p]
            lib.anerf_fused_encode_mlp_pts_v1.restype = i
        elif name == 'fused_render_bwd_sm90':
            lib.anerf_fused_bwd_sm90.argtypes = \
                [i, i] + [p] * 21 + [i] * 4 + [p] + [i] * 5 + [f, p]
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
    take: point indices within 32 bits, packed weights of the config's
    shapes, and each tensor (name=(tensor, shape or None, dtype))
    contiguous, of its type and shape, on `device`, a CUDA device."""
    if device.type != 'cuda':
        raise ValueError(f'{fn}: no kernel for {device}')
    if 4 * n_points >= 2 ** 31:
        raise ValueError('the kernels index points with 32-bit ints: '
                         f'{n_points} points are too many; split them')
    W = ncfg.width
    tensors = {'w': (packed['w'], None, torch.bfloat16),
               'b': (packed['b'], None, torch.float32),
               'w_rgb': (packed['w_rgb'], (3, W // 2), torch.float32),
               'w_alpha': (packed['w_alpha'], (W,), torch.float32),
               'b_out': (packed['b_out'], (4,), torch.float32),
               'skip': (packed['skip'], (ncfg.depth,), torch.int32),
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
    """`check_kernel_operands` for K1's operands (and K2's `extra`)."""
    R = pts.shape[0]
    check_kernel_operands(
        fn, ncfg, packed, pts.device, R * S,
        pts=(pts, (R, S, 3), torch.float32),
        m_all=(m_all, (R * 3, C72), torch.float32),
        aux=(aux, (R, aux_width(packed['fc'])), torch.float32),
        cut=(packed['cut'], (N_JOINTS,), torch.float32), **extra)


def _check_v1(fn: str, ncfg: NeRFConfig, fc: int) -> None:
    """The first versions (K1-v1 .. K4-v1) stay comparisons at the
    flagship's family: trunk width 256, at most 31 trunk layers (a 32-bit
    skip mask) and 16 framecode columns."""
    if ncfg.width != KERNEL_WIDTH or ncfg.depth > 31 or fc != FC_CH:
        raise ValueError(f'{fn}: the first versions take width '
                         f'{KERNEL_WIDTH}, at most 31 trunk layers and '
                         f'{FC_CH} framecode columns only')


#: an H100 block's opt-in shared-memory maximum (csrc/sm90_common.cuh:
#: MAX_SMEM)
SM90_MAX_SMEM = 232448
#: weight stages of K1's ring where they fit (csrc/fused_render_sm90.cu:
#: STAGES); 2 where only two do
SM90_STAGES = 3


def sm90_smem_bytes(k0: int, kv: int, stages: int = SM90_STAGES) -> int:
    """Shared memory of K1's single kernel (and K3's, K4's) for MLP inputs
    of k0 and kv columns and `stages` weight stages, as
    csrc/fused_render_sm90.cu plans it (make_layout, smem_bytes_sm90):
    the X0 region (X0's 64-column chunks, or XV's less the activation
    buffer it spills into), two activation buffers, the windows, the head
    partials, the weight stages and their barriers, and the alignment
    slack."""
    W, TM = KERNEL_WIDTH, 64
    chunk = TM * SLICE_K * 2                  # bytes of a 64 x 64 bf16 chunk
    xr = max(_rup64(k0), _rup64(kv) - W) // SLICE_K
    return ((xr + 2 * W // SLICE_K) * chunk + TM * N_JOINTS * 4
            + 2 * TM * 4 * 4 + stages * W * SLICE_K * 2
            + 2 * stages * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class Route:
    """How K1, K3, K4 and K2's recompute run a config: 'single' (K1's one
    kernel, csrc/fused_render_sm90.cu, with `stages` weight stages and
    `smem` bytes of shared memory) or 'layered'
    (csrc/fused_render_layered_sm90.cu: phase A, one launch a layer, the
    heads), and why."""
    kind: str
    stages: int
    smem: int
    why: str


def route_plan(ncfg: NeRFConfig, k0: int, kv: int,
               embedded: bool = False) -> Route:
    """The route of a config whose MLP inputs are k0 and kv columns wide
    (K1, K3: `input_widths`; K4, `embedded`: `fused_mlp.kernel_widths`):
    the single kernel with three weight stages where they fit beside the
    tile (the flagship: today's kernel, bit for bit), with two where only
    two do (but K4: the layered route is the faster there, chip_smoke.py
    phase 14 at multires 10 / 4), else the layered route. It never
    refuses a config the gate admits."""
    W = ncfg.width
    if W != KERNEL_WIDTH:
        return Route('layered', 0, 0,
                     f'trunk width {W}: the single kernel holds 64-point '
                     f'tiles of {KERNEL_WIDTH}-wide activations')
    for stages in (SM90_STAGES, 2):
        need = sm90_smem_bytes(k0, kv, stages)
        if need <= SM90_MAX_SMEM and embedded and stages == 2:
            return Route('layered', 0, 0,
                         'K4 at 2 weight stages: the layered route is '
                         'the faster (chip_smoke.py phase 14, the forced '
                         'comparison at multires 10 / 4; PERF.md)')
        if need <= SM90_MAX_SMEM:
            return Route('single', stages, need,
                         f'{need} bytes of shared memory at {stages} '
                         f'weight stages')
    return Route('layered', 0, 0,
                 f'MLP inputs of {k0} and {kv} columns need '
                 f'{sm90_smem_bytes(k0, kv, 2)} bytes of shared memory at '
                 f'2 weight stages, more than the {SM90_MAX_SMEM} of a '
                 'block')


def _layered_x_cols(ncfg: NeRFConfig, k0: int, kv: int, save: bool,
                    embedded: bool) -> Dict[str, Any]:
    """Where a layered call keeps its activations
    (csrc/fused_render_layered_sm90.cu: x_cols, anerf_layered_forward):
    'src' 'X' (the row-major buffer) or, with `save` (K2's recompute),
    'act' (K2's saved activations, `act_rows`' feature rows); the column
    or feature row of x0, xv, each trunk layer's output 'h' (a list),
    feat and hv there; and X's own columns: 'x_last' and 'x_hv', where
    the heads read the last trunk layer and hv, and 'ldx', X's width.
    Without `save` x0 | xv (not K4's `embedded` rows, read in place) |
    two trunk buffers the layers alternate between | hv; with it, X holds
    the heads' inputs alone: the last trunk layer | hv."""
    W, d = ncfg.width, ncfg.depth
    xv = _rup64(k0)
    h0 = xv + _rup64(kv)
    if save:
        return {'src': 'act', 'x0': 0, 'xv': xv,
                'h': [h0 + i * W for i in range(d)], 'feat': h0 + d * W,
                'hv': h0 + (d + 1) * W, 'x_last': 0, 'x_hv': W,
                'ldx': W + W // 2}
    base = 0 if embedded else h0
    h = [base + (i & 1) * W for i in range(d)]
    return {'src': 'X', 'x0': 0, 'xv': xv, 'h': h,
            'feat': base + (d & 1) * W, 'hv': base + 2 * W,
            'x_last': h[-1], 'x_hv': base + 2 * W,
            'ldx': base + 2 * W + W // 2}


def layered_columns(ncfg: NeRFConfig, k0: int, kv: int, save: bool,
                    embedded: bool) -> int:
    """bf16 columns a point of the layered route's activation buffer X
    (csrc/fused_render_layered_sm90.cu: x_cols): x0 | xv (not for K4's
    `embedded` inputs, read in place) | two activation buffers | hv; with
    `save` (K2's recompute, whose activations live in its act layout)
    the last trunk layer | hv, the heads' inputs."""
    return _layered_x_cols(ncfg, k0, kv, save, embedded)['ldx']


#: the layered route's GEMM plan (csrc/fused_render_layered_sm90.cu: GM,
#: GCL, MAX_STAGES, STG_COLS): points a tile, CTAs a cluster along the
#: points, the ring's deepest, the output columns the epilogue stages at a
#: time
LAYERED_GM = 128
LAYERED_CLUSTER = 2
LAYERED_MAX_STAGES = 4
LAYERED_STG_COLS = 128


def layered_gemm_smem(block: int) -> Tuple[int, int]:
    """(stages, shared-memory bytes) of the layered route's layer GEMM with
    output blocks of `block` columns (csrc/fused_render_layered_sm90.cu:
    gemm_stages, gemm_smem): a stage is a k-slice of A (LAYERED_GM x 64
    bf16) and of B (block x 64); the ring takes the most stages, up to
    LAYERED_MAX_STAGES, that fit in a block's SM90_MAX_SMEM beside the two
    consumer warpgroups' staged output rows (64 x LAYERED_STG_COLS bf16
    each), 1,024 bytes of alignment slack and a full and an empty barrier
    a stage."""
    stage = (LAYERED_GM + block) * SLICE_K * 2
    staging = 2 * 64 * LAYERED_STG_COLS * 2
    stages = min(LAYERED_MAX_STAGES, (SM90_MAX_SMEM - 1024 - staging
                                      - 16 * LAYERED_MAX_STAGES) // stage)
    return stages, 1024 + stages * stage + staging + 16 * stages


def layered_plan(ncfg: NeRFConfig, k0: int, kv: int, save: bool,
                 embedded: bool, n_points: int | None = None
                 ) -> List[Dict[str, Any]]:
    """The layered route's plan of each MMA layer (trunk, feature, view),
    as the host code of csrc/fused_render_layered_sm90.cu makes it
    (gemm_layer, anerf_layered_forward): its name, N outputs, A's two
    segments (source 'X' at a column of the activation buffer, 'act' at
    a feature row of K2's saved activations with `save`, or K4's 'x0' /
    'xv' input rows read in place with `embedded`; k-slices of 64
    columns), where its output goes ('out': [(dst, column or feature
    row)]: 'X', or with `save` 'act' and, for the last trunk layer and
    hv, 'X' as well), LAYERED_GM rows a tile, the output block (256 where
    N is a multiple of 256, else 128) and the number of blocks, the
    ring's stages and the shared-memory bytes (`layered_gemm_smem`), and
    the cluster: LAYERED_CLUSTER CTAs along the points where n_points
    make at least that many tiles (None: a call of many tiles), else 1.
    k0 and kv are the MLP inputs' widths; `save` is K2's recompute."""
    W, d = ncfg.width, ncfg.depth
    cols = _layered_x_cols(ncfg, k0, kv, save, embedded)
    src = cols['src']
    x0 = ('x0', 0) if embedded else (src, cols['x0'])
    xv = ('xv', 0) if embedded else (src, cols['xv'])
    nx0, nxv, nh = _rup64(k0) // SLICE_K, _rup64(kv) // SLICE_K, W // SLICE_K
    tiles = None if n_points is None else -(-n_points // LAYERED_GM)
    cluster = LAYERED_CLUSTER if tiles is None or tiles >= LAYERED_CLUSTER \
        else 1
    skips = skip_flags(ncfg)

    def out(col, x_col=None):
        return [(src, col)] + ([('X', x_col)] if save and x_col is not None
                               else [])

    layers = []
    for i in range(d):
        h_in = (src, cols['h'][i - 1], nh) if i else None
        if i == 0:
            segs = [x0 + (nx0,)]
        elif skips[i]:
            segs = [x0 + (nx0,), h_in]
        else:
            segs = [h_in]
        layers.append((f'layer {i}', W, segs,
                       out(cols['h'][i], cols['x_last'] if i == d - 1
                           else None)))
    layers.append(('feature', W, [(src, cols['h'][d - 1], nh)],
                   out(cols['feat'])))
    layers.append(('view', W // 2, [(src, cols['feat'], nh), xv + (nxv,)],
                   out(cols['hv'], cols['x_hv'])))
    plan = []
    for name, N, segs, dst in layers:
        block = 256 if N % 256 == 0 else 128
        stages, smem = layered_gemm_smem(block)
        plan.append({'layer': name, 'N': N, 'segments': segs,
                     'k_slices': sum(n for *_, n in segs), 'out': dst,
                     'rows': LAYERED_GM, 'block': block,
                     'blocks': -(-N // block), 'stages': stages,
                     'cluster': cluster, 'smem': smem})
    return plan


def skip_mask(ncfg: NeRFConfig) -> int:
    """The first versions' skip bits: bit s set for every skip after layer
    s (`_check_v1` keeps them to 31 trunk layers)."""
    return sum(1 << s for s in ncfg.skips if s < ncfg.depth - 1)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f'{fn} launch failed: '
                           + lib.anerf_cuda_error_string(err).decode())


def launch_layered(fn: str, kernel: str, mode: int, ncfg: NeRFConfig,
                   packed: Dict[str, Any], out: torch.Tensor, P: int, S: int,
                   tau, x: torch.Tensor, m_all: torch.Tensor | None,
                   aux: torch.Tensor | None, act: torch.Tensor | None = None,
                   widths: Tuple[int, int] | None = None) -> torch.Tensor:
    """K1 (mode 0: x the points, m_all and aux), K3 (1: x the raw rows) or
    K4 (2: x and aux the bf16 x0 and xv rows, of `widths` columns) on the
    layered route into `out` (P, 4), with `act` (K2's recompute, mode 0)
    also K2's saved activations. Allocates the activation buffer; counts
    the call in LAYERED_LAUNCHES[kernel]. Raises if a kernel cannot
    launch."""
    embedded = mode == 2
    if embedded:
        k0, kv = widths
        nfk, nfv, fc = k0, kv, 0
    else:
        k0, kv, nfk, nfv, fc = packed['k0'], packed['kv'], packed['nfk'], \
            packed['nfv'], packed['fc']
    ldx = layered_columns(ncfg, k0, kv, act is not None, embedded)
    X = torch.empty((P, ldx), dtype=torch.bfloat16, device=out.device)
    skip = (ctypes.c_int * ncfg.depth)(*skip_flags(ncfg))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library('fused_render_layered_sm90')
    with torch.cuda.device(out.device):
        err = lib.anerf_layered_forward(
            mode, x.data_ptr(), ptr(m_all), ptr(aux), packed['img'].data_ptr(),
            packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
            ptr(packed.get('cut')), out.data_ptr(), P, S, ncfg.width,
            ncfg.depth, ctypes.cast(skip, ctypes.c_void_p), nfk, nfv, fc,
            float(tau), X.data_ptr(), ldx, ptr(act), _stream(out.device))
    _raise_on(lib, err, f'{fn} (layered)')
    LAYERED_LAUNCHES[kernel] += 1
    return out


def launch_k1(fn: str, stage: int | None, ncfg: NeRFConfig,
              packed: Dict[str, Any], pts: torch.Tensor, m_all: torch.Tensor,
              aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """Launch K1 (`stage` None) on its route (`route_plan`) or K1-d
    stopped after `stage` (ST_* of csrc/fused_render_common.cuh; the
    single kernel at three stages only) on CUDA tensors; returns raw or
    the stage's digest (R, S, 4). Raises if the kernel cannot launch."""
    route = route_plan(ncfg, packed['k0'], packed['kv'])
    if stage is not None and (route.kind, route.stages) != ('single',
                                                             SM90_STAGES):
        raise ValueError(f'{fn}: the staged K1 runs the single kernel at '
                         f'{SM90_STAGES} stages only ({route.why})')
    _check_operands(fn, ncfg, packed, pts, m_all, aux, S,
                    img=image_operand(ncfg, packed))
    if aux.data_ptr() % 16 or packed['img'].data_ptr() % 16:
        raise ValueError(f'{fn}: aux and the weight image must be 16-byte '
                         'aligned (the kernel reads them 16 bytes at a time)')
    R = pts.shape[0]
    out = torch.empty((R, S, 4), dtype=torch.float32, device=pts.device)
    if R * S == 0:
        return out
    if route.kind == 'layered':
        return launch_layered(fn, 'k1', 0, ncfg, packed, out, R * S, S, tau,
                              pts, m_all, aux)
    lib = _library('fused_render_sm90')
    entry, head = ((lib.anerf_fused_encode_mlp_pts_sm90, route.stages)
                   if stage is None else (lib.anerf_fused_stage_sm90, stage))
    with torch.cuda.device(pts.device):
        err = entry(
            head, pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['img'].data_ptr(), packed['b'].data_ptr(),
            packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
            packed['b_out'].data_ptr(), packed['cut'].data_ptr(),
            out.data_ptr(), R * S, S, ncfg.depth, packed['skip'].data_ptr(),
            packed['nfk'], packed['nfv'], packed['fc'], float(tau),
            _stream(pts.device))
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

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    its route (`route_plan`; it raises if a kernel cannot launch)."""
    global LAUNCHES
    with trace.span('anerf.fused.k1', pts.shape[0] * S):
        if pts.device.type == 'cpu':
            return fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux,
                                            S, tau)
        out = launch_k1('fused_encode_mlp_pts', None, ncfg, packed, pts,
                        m_all, aux, S, tau)
    if out.numel():
        LAUNCHES += 1
    return out


def fused_encode_mlp_pts_v1(ncfg: NeRFConfig, packed: Dict[str, Any],
                            pts: torch.Tensor, m_all: torch.Tensor,
                            aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """K1-v1, K1's first (mma.sync) kernel, on the same operands: the
    comparison chip_smoke.py measures K1 against at the flagship's family
    (`_check_v1`). No path of the port calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global V1_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                        tau)
    _check_operands('fused_encode_mlp_pts_v1', ncfg, packed, pts, m_all,
                    aux, S)
    _check_v1('fused_encode_mlp_pts_v1', ncfg, packed['fc'])
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
    """Launch K3 (K1's kernel in its IN_RAW mode, on the weight image, on
    its route) or K3-v1 (K1-v1's body, on 'w') on CUDA tensors. Raises if
    the kernel cannot launch."""
    lead = x_raw.shape[:-1]
    P = x_raw[..., 0].numel()
    check_kernel_operands(
        fn, ncfg, packed, x_raw.device, P,
        x_raw=(x_raw, (*lead, raw_width(packed['fc'])), torch.float32),
        cut=(packed['cut'], (N_JOINTS,), torch.float32),
        **({} if v1 else {'img': image_operand(ncfg, packed)}))
    if v1:
        _check_v1(fn, ncfg, packed['fc'])
    if not v1 and (x_raw.data_ptr() % 16 or packed['img'].data_ptr() % 16):
        raise ValueError(f'{fn}: x_raw and the weight image must be 16-byte '
                         'aligned (the kernel reads them 16 bytes at a time)')
    out = torch.empty((*lead, 4), dtype=torch.float32, device=x_raw.device)
    if P == 0:
        return out
    if v1:
        lib = _library('fused_render_modes')
        with torch.cuda.device(x_raw.device):
            err = lib.anerf_fused_encode_mlp_raw(
                x_raw.data_ptr(), packed['w'].data_ptr(),
                packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
                packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
                packed['cut'].data_ptr(), out.data_ptr(), P, ncfg.depth,
                skip_mask(ncfg), packed['nfk'], packed['nfv'], float(tau),
                _stream(x_raw.device))
        _raise_on(lib, err, fn)
        return out
    route = route_plan(ncfg, packed['k0'], packed['kv'])
    if route.kind == 'layered':
        return launch_layered(fn, 'k3', 1, ncfg, packed, out, P, 1, tau,
                              x_raw, None, None)
    lib = _library('fused_render_sm90')
    with torch.cuda.device(x_raw.device):
        err = lib.anerf_fused_encode_mlp_raw_sm90(
            route.stages, x_raw.data_ptr(), packed['img'].data_ptr(),
            packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
            packed['cut'].data_ptr(), out.data_ptr(), P, ncfg.depth,
            packed['skip'].data_ptr(), packed['nfk'], packed['nfv'],
            packed['fc'], float(tau), _stream(x_raw.device))
    _raise_on(lib, err, fn)
    return out


def fused_encode_mlp(ncfg: NeRFConfig, packed: Dict[str, Any],
                     x_raw: torch.Tensor, tau) -> torch.Tensor:
    """K3: raw inputs (..., raw_width(fc)) from `build_raw_inputs` -> raw
    (..., 4): cutoff PE + MLP, with K1's operands from
    `pack_render_params`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    its route (and raise if it cannot launch)."""
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
    comparison chip_smoke.py measures K3 against at the flagship's family.
    No path of the port calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global RAW_V1_LAUNCHES
    if x_raw.device.type == 'cpu':
        return fused_encode_mlp_ref(ncfg, packed, x_raw, tau)
    out = _launch_k3('fused_encode_mlp_v1', ncfg, packed, x_raw, tau, True)
    if out.numel():
        RAW_V1_LAUNCHES += 1
    return out


def _mma_products(ncfg: NeRFConfig, k0p: int, kvp: int
                  ) -> List[Tuple[str, List[Tuple[str, int, int]]]]:
    """K2's layer launches in order (csrc/fused_render_bwd_sm90.cu:
    run_bwd): (label, [(role, m_tiles or k_slices, n_tiles)]) per MMA
    layer, view first, then feature and the trunk from its last layer.
    A 'dwt' product is dW^T of one input segment (m_tiles: the layer's
    outputs / 64; n_tiles: the segment's rows / 256, rounded up); a 'dx'
    product is the cotangent of one input segment (k_slices: outputs /
    64)."""
    W, WV = ncfg.width, ncfg.width // 2
    t = lambda n: -(-n // BWD_TILE_N)
    out = [('view', [('dwt', WV // SLICE_K, t(W)), ('dwt', WV // SLICE_K,
                                                      t(kvp)),
                     ('dx', WV // SLICE_K, t(W)), ('dx', WV // SLICE_K,
                                                   t(kvp))]),
           ('feature', [('dwt', W // SLICE_K, t(W)),
                        ('dx', W // SLICE_K, t(W))])]
    skips = skip_flags(ncfg)
    for i in range(ncfg.depth - 1, -1, -1):
        x0 = i == 0 or skips[i]
        prods = [('dwt', W // SLICE_K, t(k0p))] if x0 else []
        prods += [('dwt', W // SLICE_K, t(W))] if i else []
        prods += [('dx', W // SLICE_K, t(k0p))] if x0 else []
        prods += [('dx', W // SLICE_K, t(W))] if i else []
        out.append((f'layer {i}', prods))
    return out


#: the bf16 flavour's plan (csrc/fused_render_bwd_sm90.cu: run_bwd_bf16):
#: the dW partials a layer writes, about (fewer where the points make
#: fewer tiles of BF16_CHUNK_TILES)
BF16_CHUNKS = 16
#: a chunk's 64-point tiles are a multiple of this
BF16_CHUNK_TILES = 4
#: the f32 flavour's DX CTAs take this many 64-point tiles
#: (csrc/fused_render_bwd_sm90.cu: DX_ITEMS)
BWD_DX_ITEMS = 8
#: hv columns a dhv block of the bf16 flavour's heads takes (DHV_SLAB)
DHV_SLAB = 32


def bf16_grid(P: int, W: int) -> Tuple[int, int]:
    """(points a dW partial covers, 64-point tiles a DX CTA takes) of the
    bf16 flavour on P points of a trunk of width W: chunks of a multiple
    of BF16_CHUNK_TILES tiles, about BF16_CHUNKS of them, and DX CTAs of a
    chunk's tiles over the trunk's 64-output slices (a DWT CTA's MMAs)."""
    T = -(-P // SLICE_K)
    g = BF16_CHUNK_TILES * -(-T // (BF16_CHUNKS * BF16_CHUNK_TILES))
    return g * SLICE_K, max(1, g // (W // SLICE_K))


def bias_map(ncfg: NeRFConfig, nfk: int, nfv: int) -> List[Tuple[int, int,
                                                                 int]]:
    """(offset in the flat dW, length, column of the bias partials) of
    every MMA layer's bias row, in dW order (trunk, feature, view): the
    table K2's bf16 chunk sum reads (reduce_chunks_kernel). The bias
    partials hold trunk layer i at column i W, the feature layer at
    depth W, the view layer at (depth + 1) W."""
    out, off = [], 0
    W = ncfg.width
    for i, (_, r, c) in enumerate(grad_blocks(ncfg, nfk, nfv)[:-2]):
        out.append((off + (r - 1) * c, c, i * W))
        off += r * c
    return out


_BIAS_MAP: Dict[Any, torch.Tensor] = {}


def bias_map_operand(ncfg: NeRFConfig, nfk: int, nfv: int, device
                     ) -> torch.Tensor:
    """`bias_map` as the kernel reads it: int64 (layers, 3), cached per
    config and device."""
    key = (ncfg.width, ncfg.depth, tuple(ncfg.skips), nfk, nfv,
           fc_width(ncfg), str(device))
    if key not in _BIAS_MAP:
        _BIAS_MAP[key] = torch.tensor(bias_map(ncfg, nfk, nfv),
                                      dtype=torch.int64, device=device)
    return _BIAS_MAP[key]


_BWD_PLANS: Dict[Any, Dict[str, Any]] = {}


def bwd_plan(ncfg: NeRFConfig, packed: Dict[str, Any], P: int,
             bwd_f32: bool) -> Dict[str, Any]:
    """K2's plan for P points of one net in the flavour `bwd_f32`, as
    `launch_bwd` and csrc/fused_render_bwd_sm90.cu make it:
      * 'chunk': points a dW partial covers (the f32 flavour BWD_CHUNK;
        the bf16 flavour a multiple of BF16_CHUNK_TILES tiles of 64 from
        P, so that a layer writes about BF16_CHUNKS partials),
        'n_chunk' the partials;
      * 'dx_items': 64-point tiles a DX CTA walks (f32: BWD_DX_ITEMS;
        bf16: the chunk's tiles over the trunk's 64-output slices, so
        that a DX CTA does a DWT CTA's MMAs), 'n_dx_groups' the DX CTAs
        of one 256-column tile (bf16: also the rows of the bias partials
        'bpart', which the DX epilogues and the heads' dhv blocks write);
      * 'launches': [{'label', 'kernel', 'ctas'}] in launch order: the
        recompute's (the single kernel's one, or the layered route's,
        labelled 'recompute: ...'), 'heads', each MMA layer's ('view',
        'feature', 'layer d-1' .. 'layer 0'; 'ctas' {'dx', 'dwt'}),
        'chunk sum', 'PE'; 'kernel' the fragment of the device kernel's
        name;
      * 'scratch': {name: (dtype, shape)} of the buffers `launch_bwd`
        allocates after the recompute (f32: the cotangents as (P, cols)
        f32 rows; bf16: dhv, dh_a and dh_b as bf16 tiles in act's layout,
        (tiles, cols, 64), and only dx0 and dxv, which the f32 PE
        backward reads, as f32 rows);
      * 'cot_bytes': bytes of a stored MMA-layer cotangent (4 or 2).
    Cached per config, P and flavour (a call's host time is part of a
    step's): callers read it and change nothing in it."""
    key = (ncfg.width, ncfg.depth, tuple(ncfg.skips), packed['nfk'],
           packed['nfv'], packed['fc'], packed['k0'], packed['kv'], P,
           bwd_f32)
    if key not in _BWD_PLANS:
        _BWD_PLANS[key] = _bwd_plan(ncfg, packed, P, bwd_f32)
    return _BWD_PLANS[key]


def _bwd_plan(ncfg: NeRFConfig, packed: Dict[str, Any], P: int,
              bwd_f32: bool) -> Dict[str, Any]:
    nfk, nfv = packed['nfk'], packed['nfv']
    _, k0p, _, kvp = input_widths(nfk, nfv, packed['fc'])
    W, WV = ncfg.width, ncfg.width // 2
    T = -(-P // SLICE_K)
    chunk, dx_items = ((BWD_CHUNK, BWD_DX_ITEMS) if bwd_f32 else
                       bf16_grid(P, W))
    n_chunk, n_dxg = -(-P // chunk), -(-T // dx_items)
    route = route_plan(ncfg, packed['k0'], packed['kv'])
    if route.kind == 'single':
        launches = [{'label': 'recompute', 'kernel': 'k1_sm90_kernel',
                     'ctas': None}]
    else:
        frag = {'phase A': 'phase_a_act_kernel', 'heads': 'heads_kernel'}
        launches = [{'label': f'recompute: {lab}',
                     'kernel': frag.get(lab, 'layer_gemm_kernel'),
                     'ctas': None}
                    for lab in ['phase A'] + [f'layer {i}' for i in
                                              range(ncfg.depth)]
                    + ['feature', 'view', 'heads']]
    # the heads' rows: 32 a block (f32), 8 (bf16); dhv: a block a tile
    # (f32), a DX group's DHV_SLAB columns (bf16)
    rows = WV + 1 + W + 1
    launches.append({'label': 'heads', 'kernel': 'heads_bwd_kernel',
                     'ctas': n_chunk * -(-rows // 32) + T if bwd_f32 else
                     n_chunk * -(-rows // 8) + n_dxg * (WV // DHV_SLAB)})
    for label, prods in _mma_products(ncfg, k0p, kvp):
        ctas = {'dx': 0, 'dwt': 0}
        for role, m, n in prods:
            ctas[role] += n_dxg * n if role == 'dx' else n_chunk * m * n
        launches.append({'label': label, 'kernel': 'bwd_layer_kernel',
                         'ctas': ctas})
    launches += [{'label': 'chunk sum', 'kernel': 'reduce_chunks_kernel',
                  'ctas': None},
                 {'label': 'PE', 'kernel': 'pe_transform_bwd_kernel',
                  'ctas': None}]
    n_grad = sum(r * c for _, r, c in grad_blocks(ncfg, nfk, nfv))
    f32, bf = torch.float32, torch.bfloat16
    if bwd_f32:
        scratch = {'dhv': (f32, (P, WV)), 'dview': (f32, (P, W + kvp)),
                   'dh_a': (f32, (P, W)), 'dh_b': (f32, (P, W)),
                   'dx0': (f32, (P, k0p)),
                   'partial': (f32, (n_chunk, n_grad))}
    else:
        scratch = {'dhv': (bf, (T, WV, SLICE_K)), 'dxv': (f32, (P, kvp)),
                   'dh_a': (bf, (T, W, SLICE_K)),
                   'dh_b': (bf, (T, W, SLICE_K)), 'dx0': (f32, (P, k0p)),
                   'partial': (f32, (n_chunk, n_grad)),
                   'bpart': (f32, (n_dxg, (ncfg.depth + 1) * W + WV))}
    return {'bwd_f32': bwd_f32, 'P': P, 'tiles': T, 'chunk': chunk,
            'n_chunk': n_chunk, 'dx_items': dx_items, 'n_dx_groups': n_dxg,
            'launches': launches, 'scratch': scratch,
            'cot_bytes': 4 if bwd_f32 else 2}


def _bwd_scratch(ncfg: NeRFConfig, packed: Dict[str, Any], P: int,
                 dev, bwd_f32: bool = True) -> Dict[str, torch.Tensor]:
    """K2's scratch buffers as `bwd_plan` sizes them (K2-v1 takes the f32
    flavour's: f32 cotangents and per-chunk dW partials)."""
    return {name: torch.empty(shape, dtype=dt, device=dev) for name,
            (dt, shape) in bwd_plan(ncfg, packed, P, bwd_f32)['scratch']
            .items()}


def _bwd_outputs(ncfg: NeRFConfig, packed: Dict[str, Any], R: int, S: int,
                 dev) -> Dict[str, torch.Tensor]:
    n_grad = sum(r * c for _, r, c in grad_blocks(ncfg, packed['nfk'],
                                                  packed['nfv']))
    f32 = dict(dtype=torch.float32, device=dev)
    return {'dW': torch.zeros((n_grad,), **f32),
            'dpts': torch.zeros((R, S, 3), **f32),
            'dm': torch.zeros((R * 3, C72), **f32),
            'daux': torch.zeros((R, aux_width(packed['fc'])), **f32)}


def launch_bwd(stage: int, ncfg: NeRFConfig, packed: Dict[str, Any],
               pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
               S: int, tau, g: torch.Tensor, bwd_f32: bool = True
               ) -> Dict[str, torch.Tensor]:
    """Launch K2's sequence on CUDA tensors, stopped after `stage` (K2-d's
    codes, kernels/stages.py: 0 full, 1 recompute, 2 mlp, 3 pe): K1's
    forward with SAVE on its route (`route_plan`: the single kernel of
    csrc/fused_render_sm90.cu, or the layered route of
    csrc/fused_render_layered_sm90.cu), then the layer launches of
    csrc/fused_render_bwd_sm90.cu, whose cotangent products are
    f32-accurate (bwd_f32: three bf16 planes of each f32 cotangent) or
    take the cotangent rounded to bf16 (not bwd_f32, the JAX
    `bwd_f32=False` flavour: bwd_layer_kernel_bf16 on bf16 cotangent
    tiles). Allocates the outputs and the scratch
    (`bwd_plan`) and returns them by name: dW, dpts, dm, daux, act (the
    saved bf16 activations in `act_image` layout, 2 F bytes a point,
    7,168 at the flagship, and one spare tile), raw, the cotangents dhv,
    dh_a, dh_b (f32 rows, or bf16 tiles in `act_image` layout), dx0 and
    dxv (f32 rows, the MLP inputs'; the f32 flavour's dxv a view of its
    dview, d[feat | xv]), the per-chunk dW partial sums and, in the bf16
    flavour, the bias partials 'bpart'. A sequence stopped early leaves
    the outputs it does not reach zero."""
    R = pts.shape[0]
    nfk, nfv = packed['nfk'], packed['nfv']
    n_img_t = _t_image_numel(ncfg, nfk, nfv)
    route = route_plan(ncfg, packed['k0'], packed['kv'])
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
    if route.kind == 'layered':
        launch_layered('fused_bwd (recompute)', 'k2', 0, ncfg, packed,
                       t['raw'], P, S, tau, pts, m_all, aux, act=t['act'])
    else:
        lib = _library('fused_render_sm90')
        with torch.cuda.device(dev):
            err = lib.anerf_k2_recompute_sm90(
                route.stages, pts.data_ptr(), m_all.data_ptr(),
                aux.data_ptr(), packed['img'].data_ptr(),
                packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
                packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
                packed['cut'].data_ptr(), t['raw'].data_ptr(), P, S,
                ncfg.depth, packed['skip'].data_ptr(), nfk, nfv,
                packed['fc'], float(tau), t['act'].data_ptr(), stream)
        _raise_on(lib, err, 'fused_bwd (recompute)')
    if stage == 1:
        return t
    plan = bwd_plan(ncfg, packed, P, bwd_f32)
    scratch = _bwd_scratch(ncfg, packed, P, dev, bwd_f32)
    t.update(scratch)
    if bwd_f32:
        t['dxv'] = t['dview'][:, ncfg.width:]
    cot = [scratch[k] for k in ('dhv', 'dview' if bwd_f32 else 'dxv', 'dh_a',
                                'dh_b', 'dx0', 'partial')]
    bias = (None, None) if bwd_f32 else (
        scratch['bpart'], bias_map_operand(ncfg, nfk, nfv, dev))
    skip = (ctypes.c_int * ncfg.depth)(*skip_flags(ncfg))
    lib = _library('fused_render_bwd_sm90')
    with torch.cuda.device(dev):
        err = lib.anerf_fused_bwd_sm90(
            stage, int(bwd_f32), pts.data_ptr(), m_all.data_ptr(),
            aux.data_ptr(),
            packed['cut'].data_ptr(), packed['img_t'].data_ptr(),
            t['act'].data_ptr(),
            g.data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(),
            *(x.data_ptr() for x in cot),
            *(None if x is None else x.data_ptr() for x in bias),
            t['dW'].data_ptr(), t['dpts'].data_ptr(), t['dm'].data_ptr(),
            t['daux'].data_ptr(), P, S, ncfg.width, ncfg.depth,
            ctypes.cast(skip, ctypes.c_void_p), nfk, nfv, packed['fc'],
            plan['chunk'], plan['dx_items'], float(tau), stream)
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
    daux (R, 144 + fc)), all f32.

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
    against at the flagship's family. No path of the port calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    sequence (and raise if it cannot launch)."""
    global BWD_V1_LAUNCHES
    if pts.device.type == 'cpu':
        return fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g)
    R = pts.shape[0]
    _check_operands('fused_bwd_v1', ncfg, packed, pts, m_all, aux, S,
                    g=(g, (R, S, 4), torch.float32))
    _check_v1('fused_bwd_v1', ncfg, packed['fc'])
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
    k0, k0p, _, _ = input_widths(nfk, nfv, fc_width(ncfg))
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
        with trace.span('anerf.fused.k2', pts.shape[0] * ctx.S):
            dW, dpts, dm, daux = fused_bwd(ctx.ncfg, p, pts, m_all, aux,
                                           ctx.S, ctx.tau,
                                           g.contiguous().float(),
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
