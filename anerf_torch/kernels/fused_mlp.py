"""K4: the NeRF MLP alone, fused into one kernel, on inputs that are
already embedded (port of anerf_tpu/kernels/fused_mlp.py).

`fused_mlp_apply` launches K4 on CUDA tensors, on the route
`fused_render.route_plan` picks for its input widths: K1's single wgmma
kernel in its IN_EMBEDDED mode (csrc/fused_render_sm90.cu: phase A
copies bf16 input rows, the weights come from the weight image 'img' by
cluster-multicast bulk copies), or the layered route
(csrc/fused_render_layered_sm90.cu: one launch a layer on the same
weight image, reading the input rows in place) for a trunk wider than
256 or inputs wider than three weight stages leave room for beside the
single kernel's tile (at two stages the layered route is the faster). It
runs its plain PyTorch version, `fused_mlp_apply_ref`, on CPU tensors;
it never falls back from one to the other. `fused_mlp_apply_v1` launches K4-v1, its first kernel
(csrc/fused_render_modes.cu, K1-v1's mma.sync body on the fragment-order
'w'), kept as the comparison; no path of the port runs it. The operands
are K1's, packed by `pack_params` for input widths k0 = dnet_input and
kv = input_ch_views (+ framecode_ch), so that every config JAX's gate
admits works (`supports_config`): any depth, width and skips,
input_ch_bones = 0, any input widths.

Numerics, as the TPU kernel's `_mlp_chain`: bf16 operands, each product
kept in f32 before the bias add, activations rounded to bf16 between
layers, the rgb and alpha heads on bf16 activations and weights with f32
sums.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.nerf import NeRFConfig
from . import fused_render as fr

#: K4 launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0
#: K4-v1 launches since the last reset; `fused_mlp_apply_v1` adds one per
#: launch.
V1_LAUNCHES = 0


def view_in(cfg: NeRFConfig) -> int:
    """Width of the view input: embedded view dirs (+ framecode)."""
    return cfg.input_ch_views + (cfg.framecode_ch if cfg.use_framecode
                                 else 0)


def kernel_widths(cfg: NeRFConfig) -> Tuple[int, int]:
    """(k0, kv): the row widths the kernels copy, dnet_input and
    `view_in` rounded up to multiples of 8 (16 bytes of bf16)."""
    return -(-cfg.dnet_input // 8) * 8, -(-view_in(cfg) // 8) * 8


def supports_config(cfg: NeRFConfig) -> bool:
    """The JAX gate, condition for condition: a view head, depth 2 or
    more, the width and half of it multiples of the TPU's 128 lanes. The
    kernels' own limits pick a route (`fused_render.route_plan`)."""
    return (cfg.use_viewdirs
            and cfg.width % fr.LANE == 0
            and (cfg.width // 2) % fr.LANE == 0
            and cfg.depth >= 2)


def pack_params(params: Dict[str, Any], cfg: NeRFConfig) -> Dict[str, Any]:
    """One network's params -> K4's operands: K1's MLP operands
    (`fused_render.pack_mlp_params`, with the weight image 'img') for
    input widths dnet_input and `view_in(cfg)`, each padded to 16 in 'w'
    and to 64 in 'img'."""
    return fr.pack_mlp_params(params, cfg, cfg.dnet_input, view_in(cfg))


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


def _launch(fn: str, cfg: NeRFConfig, packed: Dict[str, Any],
            x_pts: torch.Tensor, x_view: torch.Tensor, v1: bool
            ) -> torch.Tensor:
    """Launch K4 (K1's kernel in its IN_EMBEDDED mode, on the weight
    image, on its route) or K4-v1 (K1-v1's body, on 'w') on x_pts and
    x_view of any device but the CPU. Raises if the kernel cannot
    launch."""
    P = x_pts.shape[0]
    bf = torch.bfloat16
    k0, kv = kernel_widths(cfg)

    # the kernels copy 16-byte chunks: rows of a multiple of 8 columns
    # (zero columns added here where a width is not), 16-byte aligned
    def rows(x, k):
        x = x.to(bf)
        if x.shape[-1] != k:
            x = torch.nn.functional.pad(x, (0, k - x.shape[-1]))
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    x0, xv = rows(x_pts, k0), rows(x_view, kv)
    fr.check_kernel_operands(
        fn, cfg, packed, x_pts.device, P, x_pts=(x0, (P, k0), bf),
        x_view=(xv, (P, kv), bf),
        **({} if v1 else {'img': fr.image_operand(cfg, packed)}))
    if v1:
        fr._check_v1(fn, cfg, fr.FC_CH)
    if not v1 and packed['img'].data_ptr() % 16:
        raise ValueError(f'{fn}: the weight image must be 16-byte aligned')
    out = torch.empty((P, 4), dtype=torch.float32, device=x_pts.device)
    if P == 0:
        return out
    route = fr.route_plan(cfg, k0, kv, embedded=True)
    if not v1 and route.kind == 'layered':
        return fr.launch_layered(fn, 'k4', 2, cfg, packed, out, P, 1, 0.0,
                                 x0, None, xv, widths=(k0, kv))
    lib = fr._library('fused_render_modes' if v1 else 'fused_render_sm90')
    with torch.cuda.device(x_pts.device):
        if v1:
            err = lib.anerf_fused_mlp(
                x0.data_ptr(), xv.data_ptr(), packed['w'].data_ptr(),
                packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
                packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr(),
                out.data_ptr(), P, cfg.depth, fr.skip_mask(cfg), k0, kv,
                fr._stream(x_pts.device))
        else:
            err = lib.anerf_fused_mlp_sm90(
                route.stages, x0.data_ptr(), xv.data_ptr(),
                packed['img'].data_ptr(), packed['b'].data_ptr(),
                packed['w_rgb'].data_ptr(), packed['w_alpha'].data_ptr(),
                packed['b_out'].data_ptr(), out.data_ptr(), P, cfg.depth,
                packed['skip'].data_ptr(), k0, kv, fr._stream(x_pts.device))
    fr._raise_on(lib, err, fn)
    return out


def fused_mlp_apply(cfg: NeRFConfig, packed: Dict[str, Any],
                    x_pts: torch.Tensor, x_view: torch.Tensor
                    ) -> torch.Tensor:
    """K4: embedded inputs x_pts (P, dnet_input) and x_view (P, view_in),
    cast to bf16, -> raw (P, 4) f32 = [rgb logits, sigma].

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    its route (and raise if it cannot launch)."""
    global LAUNCHES
    if x_pts.device.type == 'cpu':
        return fused_mlp_apply_ref(cfg, packed, x_pts, x_view)
    out = _launch('fused_mlp_apply', cfg, packed, x_pts, x_view, False)
    if out.numel():
        LAUNCHES += 1
    return out


def fused_mlp_apply_v1(cfg: NeRFConfig, packed: Dict[str, Any],
                       x_pts: torch.Tensor, x_view: torch.Tensor
                       ) -> torch.Tensor:
    """K4-v1, K4's first (mma.sync) kernel, on the same operands: the
    comparison chip_smoke.py measures K4 against. No path of the port
    calls it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    global V1_LAUNCHES
    if x_pts.device.type == 'cpu':
        return fused_mlp_apply_ref(cfg, packed, x_pts, x_view)
    out = _launch('fused_mlp_apply_v1', cfg, packed, x_pts, x_view, True)
    if out.numel():
        V1_LAUNCHES += 1
    return out
