"""K1-d and K2-d: K1 and K2 stopped after a stage, to attribute their
in-kernel cost (port of the staged kernels of tools/kernel_bench.py:
decompose and decompose_bwd, which stop the TPU kernels'
_render_kernel_pts / _render_kernel_pts_bwd early).

A stage's time minus the previous stage's is the cost of the work in
between. A stage writes a digest of every value it computed, so that the
compiler keeps all of that work, and each digest has a plain PyTorch
version here (`*_ref`), which the CPU tests and chip_smoke.py hold the
kernels to. On CPU tensors the wrappers run the plain versions; on CUDA
tensors they launch the kernels or raise.

K1-d (csrc/fused_render_sm90.cu, `anerf_fused_stage_sm90`: the body of
K1 itself), digests of (R, S, 4):
  transform    the geometry: per point (sum_j v, sum_j r_x, sum_j r_y,
               sum_j r_z) over the 24 joints' distances and unit dirs;
  pe           both PE phases, accurate sincosf: per point and k = 0..3,
               the sum of the bf16 MLP inputs x0 and xv in the columns c
               with c % 4 == k;
  pe_notrig    the same with sin / cos replaced by the polynomial
               stand-in of the TPU tool (x / 2 - 0.124 x^2,
               1 - 0.437 x^2);
  pe_fasttrig  the same with the __sincosf intrinsic (its plain version
               uses accurate sin / cos, which the digest's tolerance
               covers);
  full         K1 itself: raw (R, S, 4), the same bits as K1.
K2-d (K2's own sequence, `fused_render.launch_bwd`: K1's kernel with SAVE,
then csrc/fused_render_bwd_sm90.cu's `anerf_fused_bwd_sm90` stopped after
the stage), in either of K2's flavours (`bwd_f32`: f32-accurate cotangent
products, or bf16 cotangent operands):
  recompute    the forward with saved activations: raw (R, S, 4);
  mlp          + the MLP backward and the dW chunk sums: (dW, dx0
               (R, S, k0p), dxv (R, S, kvp)), the MLP inputs' cotangents;
  pe           + the cutoff-PE backward, without the transform's: (dW,
               (R, S, 3) per point (sum_j dv_j, sum_c dd_c, sum_c dr_c));
  full         K2 itself: (dW, dpts, dm_all, daux), the same bits as K2.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.nerf import NeRFConfig
from . import fused_render as fr

#: K1-d stages, in order, with their codes in csrc/fused_render_common.cuh
#: (ST_*), which csrc/fused_render_sm90.cu takes.
FWD_STAGES = {'transform': 1, 'pe': 2, 'pe_notrig': 3, 'pe_fasttrig': 4,
              'full': 0}
#: K2-d stages, in order, with their codes in csrc/fused_render_bwd_sm90.cu
#: (BWD_*; the recompute, 1, stops before that library).
BWD_STAGES = {'recompute': 1, 'mlp': 2, 'pe': 3, 'full': 0}

#: K1-d launches since the last reset; `decompose_fwd` adds one a launch.
FWD_LAUNCHES = 0
#: K2-d launches since the last reset; `decompose_bwd` adds one per
#: launch of a (staged) kernel sequence.
BWD_LAUNCHES = 0


def standin_sincos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cheap polynomial that stands in for sin / cos in the pe_notrig
    stage (tools/kernel_bench.py's pe_notrig swap)."""
    return x * 0.5 - x * x * 0.124, 1.0 - x * x * 0.437


def _input_digest(x0: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """(..., 4): the sums of x0's and xv's columns c with c % 4 == k."""
    fold = lambda x: x.reshape(*x.shape[:-1], -1, 4).sum(-2)
    return fold(x0) + fold(xv)


def decompose_fwd_ref(stage: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                      pts: torch.Tensor, m_all: torch.Tensor,
                      aux: torch.Tensor, S: int, tau) -> torch.Tensor:
    """The plain PyTorch version of K1-d's digest at `stage`."""
    if stage == 'full':
        return fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                           tau)
    if stage == 'transform':
        _, v, r = fr.geometry(pts, m_all, aux)
        rs = r.reshape(*r.shape[:-1], fr.N_JOINTS, 3).sum(-2)
        return torch.cat([v.sum(-1, keepdim=True), rs], -1)
    if stage not in FWD_STAGES:
        raise ValueError(f'unknown K1-d stage {stage!r}')
    sincos = standin_sincos if stage == 'pe_notrig' else fr.accurate_sincos
    return _input_digest(*fr._encode(packed, pts, m_all, aux, S, tau,
                                     sincos))


def decompose_fwd(stage: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                  pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                  S: int, tau) -> torch.Tensor:
    """K1-d: K1's operands -> the digest (R, S, 4) of `stage`.

    CPU tensors take the plain version; CUDA tensors launch the staged
    kernel (and raise if it cannot launch)."""
    global FWD_LAUNCHES
    if stage not in FWD_STAGES:
        raise ValueError(f'unknown K1-d stage {stage!r}')
    if pts.device.type == 'cpu':
        return decompose_fwd_ref(stage, ncfg, packed, pts, m_all, aux, S,
                                 tau)
    out = fr.launch_k1(f'decompose_fwd({stage})', FWD_STAGES[stage], ncfg,
                       packed, pts, m_all, aux, S, tau)
    if out.numel():
        FWD_LAUNCHES += 1
    return out


def decompose_bwd_ref(stage: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                      pts: torch.Tensor, m_all: torch.Tensor,
                      aux: torch.Tensor, S: int, tau, g: torch.Tensor,
                      bwd_f32: bool = True) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of K2-d's outputs at `stage`, in K2's
    flavour `bwd_f32`."""
    if stage == 'recompute':
        return (fr.fused_encode_mlp_pts_ref(ncfg, packed, pts, m_all, aux, S,
                                            tau),)
    if stage == 'full':
        return fr.fused_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g,
                                bwd_f32)
    if stage not in BWD_STAGES:
        raise ValueError(f'unknown K2-d stage {stage!r}')
    dW, dx0, dxv = fr.mlp_bwd_ref(ncfg, packed, pts, m_all, aux, S, tau, g,
                                  bwd_f32)
    if stage == 'mlp':
        return dW, dx0, dxv
    return dW, fr.pe_transform_bwd_ref(packed, pts, m_all, aux, S, tau, dx0,
                                       dxv, pe_only=True)


def decompose_bwd(stage: str, ncfg: NeRFConfig, packed: Dict[str, Any],
                  pts: torch.Tensor, m_all: torch.Tensor, aux: torch.Tensor,
                  S: int, tau, g: torch.Tensor, bwd_f32: bool = True
                  ) -> Tuple[torch.Tensor, ...]:
    """K2-d: K2's operands -> the outputs of `stage` (see the module
    docstring), in K2's flavour `bwd_f32`.

    CPU tensors take the plain version; CUDA tensors launch K2's kernel
    sequence stopped after the stage (and raise if it cannot launch)."""
    global BWD_LAUNCHES
    if stage not in BWD_STAGES:
        raise ValueError(f'unknown K2-d stage {stage!r}')
    if pts.device.type == 'cpu':
        return decompose_bwd_ref(stage, ncfg, packed, pts, m_all, aux, S,
                                 tau, g, bwd_f32)
    R = pts.shape[0]
    if R * S == 0:
        raise ValueError('decompose_bwd: no points')
    t = fr.launch_bwd(BWD_STAGES[stage], ncfg, packed, pts, m_all, aux, S,
                      tau, g, bwd_f32)
    BWD_LAUNCHES += 1
    if stage == 'recompute':
        return (t['raw'].view(R, S, 4),)
    if stage == 'full':
        return t['dW'], t['dpts'], t['dm'], t['daux']
    if stage == 'pe':
        return t['dW'], t['dpts']
    return t['dW'], t['dx0'].view(R, S, -1), t['dxv'].reshape(R, S, -1)
