"""K4: the NeRF MLP alone, fused into one kernel, on inputs that are
already embedded (port of anerf_tpu/kernels/fused_mlp.py).

`fused_mlp_apply` launches K4 (csrc/fused_render_modes.cu, K1-v1's
kernel body with its phase A replaced by a copy of bf16 input rows) on CUDA
tensors and runs its plain PyTorch version, `fused_mlp_apply_ref`, on CPU
tensors; it never falls back from one to the other. Its operands are
K1's, packed in the tensor cores' fragment order by `pack_params` for
input widths k0 = dnet_input and kv = input_ch_views (+ framecode_ch),
so that any depth and skips, input_ch_bones = 0 and no framecode work.

Numerics, as the TPU kernel's `_mlp_chain`: bf16 operands, each product
kept in f32 before the bias add, activations rounded to bf16 between
layers, the rgb and alpha heads on bf16 activations and weights with f32
sums.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.nerf import NeRFConfig
from . import fused_render as fr

#: K4 launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0


def view_in(cfg: NeRFConfig) -> int:
    """Width of the view input: embedded view dirs (+ framecode)."""
    return cfg.input_ch_views + (cfg.framecode_ch if cfg.use_framecode
                                 else 0)


def supports_config(cfg: NeRFConfig) -> bool:
    """The JAX gate (a view head, depth 2 or more, widths multiples of the
    TPU's 128 lanes) plus the kernel's fixed trunk width of 256."""
    return (cfg.use_viewdirs and cfg.depth >= 2
            and cfg.width == fr.KERNEL_WIDTH)


def pack_params(params: Dict[str, Any], cfg: NeRFConfig) -> Dict[str, Any]:
    """One network's params -> K4's operands: K1's MLP operands
    (`fused_render.pack_mlp_params`) for input widths dnet_input and
    `view_in(cfg)`, each padded to 16."""
    return fr.pack_mlp_params(params, cfg, fr._rup16(cfg.dnet_input),
                              fr._rup16(view_in(cfg)))


def _padded_inputs(packed, x_pts, x_view):
    """The kernel's shared-memory rows in plain torch: bf16 values, zero
    columns up to a multiple of 16, as f32."""
    bf = torch.bfloat16
    pad = lambda x, n: torch.nn.functional.pad(
        x.to(bf).float(), (0, n - x.shape[-1]))
    return pad(x_pts, packed['k0p']), pad(x_view, packed['kvp'])


def fused_mlp_apply_ref(cfg: NeRFConfig, packed: Dict[str, Any],
                        x_pts: torch.Tensor, x_view: torch.Tensor
                        ) -> torch.Tensor:
    """The plain PyTorch version of K4: x_pts (P, dnet_input), x_view
    (P, view_in) -> raw (P, 4), through the MLP of K1's plain version."""
    x0, xv = _padded_inputs(packed, x_pts, x_view)
    return fr.mlp_trace(cfg, packed, x0, xv)['out']


def fused_mlp_apply(cfg: NeRFConfig, packed: Dict[str, Any],
                    x_pts: torch.Tensor, x_view: torch.Tensor
                    ) -> torch.Tensor:
    """K4: embedded inputs x_pts (P, dnet_input) and x_view (P, view_in),
    cast to bf16, -> raw (P, 4) f32 = [rgb logits, sigma].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global LAUNCHES
    if x_pts.device.type == 'cpu':
        return fused_mlp_apply_ref(cfg, packed, x_pts, x_view)
    P = x_pts.shape[0]
    bf = torch.bfloat16
    # the kernel copies 16-byte chunks: rows of a multiple of 8 columns
    # (zero columns added here where a width is not), 16-byte aligned
    k0, kv = -(-cfg.dnet_input // 8) * 8, -(-view_in(cfg) // 8) * 8

    def rows(x, k):
        x = x.to(bf)
        if x.shape[-1] != k:
            x = torch.nn.functional.pad(x, (0, k - x.shape[-1]))
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    x0, xv = rows(x_pts, k0), rows(x_view, kv)
    fr.check_kernel_operands('fused_mlp_apply', cfg, packed, x_pts.device,
                             P, x_pts=(x0, (P, k0), bf),
                             x_view=(xv, (P, kv), bf))
    out = torch.empty((P, 4), dtype=torch.float32, device=x_pts.device)
    if P == 0:
        return out
    lib = fr._library('fused_render_modes')
    with torch.cuda.device(x_pts.device):
        err = lib.anerf_fused_mlp(
            x0.data_ptr(), xv.data_ptr(), packed['w'].data_ptr(),
            packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
            packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
            out.data_ptr(), P, cfg.depth, fr.skip_mask(cfg), k0, kv,
            fr._stream(x_pts.device))
    fr._raise_on(lib, err, 'fused_mlp_apply')
    LAUNCHES += 1
    return out
