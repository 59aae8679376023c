"""The A-NeRF MLP as a plain parameter dict with a functional forward
(torch port of anerf_tpu/models/nerf.py, forward only).

Parameter tree schema (the same keys and shapes as the JAX package, so
parameters copy across one to one; weights are (in, out), apply is
`x @ W + b`):
  {
    'pts_linears': [{'w': (in, W), 'b': (W,)} * D],
    'alpha_linear': {'w': (W, 1), 'b': (1,)},
    'feature_linear': {'w': (W, W), 'b': (W,)},
    'views_linears': [{'w': (vnet_in, W//2), 'b': (W//2,)}],
    'rgb_linear': {'w': (W//2, 3), 'b': (3,)},
    'framecodes': {'codes': (n_framecodes, framecode_ch)}   # optional
  }
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static MLP architecture config."""
    depth: int = 8
    width: int = 256
    input_ch: int = 360
    input_ch_bones: int = 72
    input_ch_views: int = 648
    output_ch: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    use_framecode: bool = False
    framecode_ch: int = 16
    n_framecodes: int = 0
    density_scale: float = 1.0

    @property
    def dnet_input(self) -> int:
        return self.input_ch + self.input_ch_bones

    @property
    def vnet_input(self) -> int:
        offset = self.framecode_ch if self.use_framecode else 0
        return self.input_ch_views + offset + self.width


def _linear_init(fan_in: int, fan_out: int, generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """torch nn.Linear default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    for weight and bias."""
    bound = 1.0 / np.sqrt(fan_in)

    def u(shape):
        x = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((x * 2.0 - 1.0) * bound).to(device)

    return {'w': u((fan_in, fan_out)), 'b': u((fan_out,))}


def init_nerf_params(cfg: NeRFConfig, generator: torch.Generator,
                     device) -> Dict[str, Any]:
    """Random parameters drawn from `generator` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    pts_linears = []
    in_dim = cfg.dnet_input
    for i in range(cfg.depth):
        pts_linears.append(_linear_init(in_dim, cfg.width, generator, device))
        in_dim = cfg.width + cfg.dnet_input if i in cfg.skips else cfg.width

    params: Dict[str, Any] = {'pts_linears': pts_linears}
    if cfg.use_viewdirs:
        params['alpha_linear'] = _linear_init(cfg.width, 1, generator, device)
        params['feature_linear'] = _linear_init(cfg.width, cfg.width,
                                                generator, device)
        params['views_linears'] = [_linear_init(cfg.vnet_input,
                                                cfg.width // 2, generator,
                                                device)]
        params['rgb_linear'] = _linear_init(cfg.width // 2, 3, generator,
                                            device)
    else:
        params['output_linear'] = _linear_init(cfg.width, cfg.output_ch,
                                               generator, device)
    if cfg.use_framecode:
        # xavier normal on the embedding
        std = np.sqrt(2.0 / (cfg.n_framecodes + cfg.framecode_ch))
        codes = torch.randn((cfg.n_framecodes, cfg.framecode_ch),
                            generator=generator, dtype=torch.float32) * std
        params['framecodes'] = {'codes': codes.to(device)}
    return params


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense layer. With compute_dtype (bf16) the product is formed from
    bf16 operands and rounded to bf16 BEFORE the f32 bias add, as the JAX
    package's XLA `_dense` does (the fused kernel instead keeps the
    product in f32; see kernels/fused_render.py)."""
    w, b = p['w'], p['b']
    if compute_dtype is None:
        return x @ w + b
    y = x.to(compute_dtype) @ w.to(compute_dtype)
    return y.float() + b


def forward_density(params: Dict[str, Any], cfg: NeRFConfig,
                    input_pts: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16
                    ) -> torch.Tensor:
    """Density trunk: D layers, ReLU, skip concat after each layer in
    cfg.skips. input_pts (..., dnet_input) -> (..., W)."""
    h = input_pts
    for i, layer in enumerate(params['pts_linears']):
        h = torch.relu(_dense(layer, h, compute_dtype))
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        if i in cfg.skips:
            h = torch.cat([input_pts.to(h.dtype), h], -1)
    return h


def lookup_framecodes(params: Dict[str, Any], idx: torch.Tensor,
                      eval_mean: bool = False) -> torch.Tensor:
    """Per-frame latent code lookup. idx (R,) frame indices, or (R, 3)
    [idx0, idx1, lerp_w]; eval_mean substitutes the mean code."""
    codes = params['framecodes']['codes']
    if eval_mean:
        mean = codes.mean(0, keepdim=True)
        return mean.expand(idx.shape[0], codes.shape[-1])
    if idx.dim() == 2 and idx.shape[-1] == 3:
        c0 = codes[idx[..., 0].long()]
        c1 = codes[idx[..., 1].long()]
        w = idx[..., 2:3]
        return c0 * (1.0 - w) + c1 * w
    return codes[idx.reshape(-1).long()]


def forward_view(params: Dict[str, Any], cfg: NeRFConfig,
                 input_views: torch.Tensor, h: torch.Tensor,
                 framecodes: Optional[torch.Tensor] = None,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16
                 ) -> torch.Tensor:
    """Radiance head. framecodes (..., framecode_ch) already per-sample."""
    feature = _dense(params['feature_linear'], h, compute_dtype)
    if cfg.use_framecode:
        if framecodes is None:
            raise ValueError('use_framecode needs framecodes')
        input_views = torch.cat([input_views, framecodes], -1)
    if compute_dtype is not None:
        feature = feature.to(compute_dtype)
        input_views = input_views.to(compute_dtype)
    hv = torch.cat([feature, input_views], -1)
    for layer in params['views_linears']:
        hv = torch.relu(_dense(layer, hv, compute_dtype))
        if compute_dtype is not None:
            hv = hv.to(compute_dtype)
    return _dense(params['rgb_linear'], hv, compute_dtype)


def apply_nerf(params: Dict[str, Any], cfg: NeRFConfig,
               input_pts: torch.Tensor, input_views: torch.Tensor,
               framecodes: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = torch.bfloat16
               ) -> torch.Tensor:
    """(..., dnet_in), (..., views_in) -> raw (..., 4) = [rgb(3), sigma]."""
    h = forward_density(params, cfg, input_pts, compute_dtype)
    if cfg.use_viewdirs:
        alpha = _dense(params['alpha_linear'], h, compute_dtype)
        rgb = forward_view(params, cfg, input_views, h, framecodes,
                           compute_dtype)
        return torch.cat([rgb, alpha], -1)
    return _dense(params['output_linear'], h, compute_dtype)
