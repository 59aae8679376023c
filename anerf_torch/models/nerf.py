"""The A-NeRF MLP as a plain parameter dict with a functional forward
(torch port of anerf_tpu/models/nerf.py).

With a bf16 compute dtype the dense layers take the JAX package's
cotangent knobs: `fast_grads` keeps activation cotangents in bf16
(`_DenseMixed`), and an SR key with it rounds them stochastically
(`_DenseMixedSR`, the --sr_grads backward). The SR keys are pairs of
uint32 words' bits in an int32 tensor on the device (`sr_salt` draws one
from a torch.Generator; `fold_in` / `key_split` derive per-layer and
per-site keys with a murmur3 mix); the noise bits of a key are the JAX
package's `_sr_noise_bits` bit for bit.

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


# ------------------------------------------- stochastic-rounding keys

# fold_in data of key_split's two halves (outside the per-layer range)
_SPLIT = (0x5EED0001, 0x5EED0002)


def _i32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return (u ^ 0x80000000) - 0x80000000


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on int32 tensors holding uint32 bits: the
    shifts masked to act as logical ones, the products wrapping mod 2^32
    as uint32's do (tests/test_torch_knobs.py holds the hash to JAX's bit
    for bit, chip_smoke.py the card's to the CPU's)."""
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _i32(0x85EBCA6B)
    h = h ^ ((h >> 13) & 0x7FFFF)
    h = h * _i32(0xC2B2AE35)
    return h ^ ((h >> 16) & 0xFFFF)


def sr_salt(generator: torch.Generator) -> torch.Tensor:
    """A fresh SR key: two uint32 words' bits from `generator`, int32 on
    its device (no host round trip)."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=generator,
                         dtype=torch.int32, device=generator.device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from `key` and a host integer (the layer index), as
    jax.random.fold_in is used in the JAX package; not its values."""
    d = (data * 0x9E3779B9 + 0x7F4A7C15) & 0xFFFFFFFF
    return _fmix32(key * _i32(0x9E3779B9) ^ _i32(d))


def key_split(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two keys from one (the two rounding sites of a layer's backward)."""
    return fold_in(key, _SPLIT[0]), fold_in(key, _SPLIT[1])


def _sr_noise_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """16 uniform noise bits per element (int32) from a counter hash: the
    JAX package's `_sr_noise_bits` bit for bit, given the same uint32 key
    words (their bits in an int32 tensor here). The salt is avalanched
    first; element i gets fmix(i * 2654435761 + salt) & 0xFFFF."""
    kd = key.reshape(-1)
    salt = _fmix32(kd[0] * _i32(0x9E3779B9) ^ kd[-1])
    n = 1
    for s in shape:
        n *= s
    h = (torch.arange(n, dtype=torch.int32, device=key.device)
         * _i32(2654435761) + salt)
    return (_fmix32(h) & 0xFFFF).reshape(shape)


def _sr_cast(x: torch.Tensor, key: torch.Tensor,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stochastically rounded f32 -> bf16 cast, E[_sr_cast(x)] == x: add
    16 noise bits below bf16's mantissa and truncate (bf16 is f32's top
    half). Bit for bit the JAX package's `_sr_cast` for the same key
    words. Finite inputs assumed."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    bits = x.float().contiguous().view(torch.int32)
    out = (bits + _sr_noise_bits(key, x.shape)) & _i32(0xFFFF0000)
    return out.view(torch.float32).to(torch.bfloat16)


# ----------------------------------------------------------- dense layers

def _grad_w(x_lo: torch.Tensor, g_lo: torch.Tensor) -> torch.Tensor:
    """sum over points of x_lo^T g_lo from bf16 operands with an f32
    result: the operands are widened to f32, where their products are
    exact, so the result is never rounded to bf16 (TF32 must be off)."""
    return (x_lo.reshape(-1, x_lo.shape[-1]).float().T
            @ g_lo.reshape(-1, g_lo.shape[-1]).float())


def _forward_mixed(w, b, x, dtype):
    y = x.to(dtype) @ w.to(dtype)
    return y.float() + b


class _DenseMixed(torch.autograd.Function):
    """The bf16 product with an f32 bias add, whose backward keeps the
    activation cotangents in bf16 (the JAX package's `_dense_mixed`):
    g rounded to bf16, gx = g_lo @ w_lo^T in bf16, gw from the bf16
    operands in f32, gb summed from the unrounded g."""

    @staticmethod
    def forward(ctx, w, b, x, dtype):
        ctx.save_for_backward(w, x)
        ctx.dtype = dtype
        return _forward_mixed(w, b, x, dtype)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        g_lo = g.to(ctx.dtype)
        gx = g_lo @ w.to(ctx.dtype).T
        gw = _grad_w(x.to(ctx.dtype), g_lo)
        gb = g.reshape(-1, g.shape[-1]).sum(0)
        return gw.to(w.dtype), gb, gx.to(x.dtype), None


class _DenseMixedSR(torch.autograd.Function):
    """Forward twin of _DenseMixed whose backward rounds both bf16 sites
    stochastically (the JAX package's `_dense_mixed_sr`, --sr_grads): the
    incoming g with the first key of key_split(key), gx (made in f32 from
    the bf16 operands) with the second when x is bf16. gw and gb as in
    _DenseMixed."""

    @staticmethod
    def forward(ctx, w, b, x, key, dtype):
        ctx.save_for_backward(w, x, key)
        ctx.dtype = dtype
        return _forward_mixed(w, b, x, dtype)

    @staticmethod
    def backward(ctx, g):
        w, x, key = ctx.saved_tensors
        k1, k2 = key_split(key)
        g_lo = _sr_cast(g, k1, ctx.dtype)
        gx32 = g_lo.float() @ w.to(ctx.dtype).float().T
        gx = (_sr_cast(gx32, k2, x.dtype) if x.dtype == torch.bfloat16
              else gx32.to(x.dtype))
        gw = _grad_w(x.to(ctx.dtype), g_lo)
        gb = g.reshape(-1, g.shape[-1]).sum(0)
        return gw.to(w.dtype), gb, gx, None, None


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None,
           fast_grads: bool = False,
           sr_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer. With compute_dtype (bf16) the product is formed from
    bf16 operands and rounded to bf16 BEFORE the f32 bias add, as the JAX
    package's XLA `_dense` does (the fused kernel instead keeps the
    product in f32; see kernels/fused_render.py). fast_grads selects the
    bf16-cotangent backward, and sr_key with it the stochastically
    rounded one; the forward is the same in all three."""
    w, b = p['w'], p['b']
    if compute_dtype is None:
        return x @ w + b
    if fast_grads:
        if sr_key is not None:
            return _DenseMixedSR.apply(w, b, x, sr_key, compute_dtype)
        return _DenseMixed.apply(w, b, x, compute_dtype)
    return _forward_mixed(w, b, x, compute_dtype)


def forward_density(params: Dict[str, Any], cfg: NeRFConfig,
                    input_pts: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    fast_grads: bool = False,
                    sr_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Density trunk: D layers, ReLU, skip concat after each layer in
    cfg.skips. input_pts (..., dnet_input) -> (..., W). Layer i's SR key
    is fold_in(sr_key, i)."""
    h = input_pts
    for i, layer in enumerate(params['pts_linears']):
        k = None if sr_key is None else fold_in(sr_key, i)
        h = torch.relu(_dense(layer, h, compute_dtype, fast_grads, k))
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
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 fast_grads: bool = False,
                 sr_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Radiance head. framecodes (..., framecode_ch) already per-sample.
    SR keys: fold_in(sr_key, 100) for feature_linear, 101 + i for the
    views layers, 150 for rgb_linear (the JAX package's numbering)."""
    def sk(i):
        return None if sr_key is None else fold_in(sr_key, 100 + i)
    feature = _dense(params['feature_linear'], h, compute_dtype, fast_grads,
                     sk(0))
    if cfg.use_framecode:
        if framecodes is None:
            raise ValueError('use_framecode needs framecodes')
        input_views = torch.cat([input_views, framecodes], -1)
    if compute_dtype is not None:
        feature = feature.to(compute_dtype)
        input_views = input_views.to(compute_dtype)
    hv = torch.cat([feature, input_views], -1)
    for i, layer in enumerate(params['views_linears']):
        hv = torch.relu(_dense(layer, hv, compute_dtype, fast_grads,
                               sk(1 + i)))
        if compute_dtype is not None:
            hv = hv.to(compute_dtype)
    return _dense(params['rgb_linear'], hv, compute_dtype, fast_grads,
                  sk(50))


def apply_nerf(params: Dict[str, Any], cfg: NeRFConfig,
               input_pts: torch.Tensor, input_views: torch.Tensor,
               framecodes: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = torch.bfloat16,
               fast_grads: bool = False,
               alpha_f32: bool = False,
               sr_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., dnet_in), (..., views_in) -> raw (..., 4) = [rgb(3), sigma].

    alpha_f32 keeps the default backward (and no SR key) on the alpha
    head under fast_grads. The heads' SR keys are fold_in(sr_key, 200)
    (alpha) and 201 (output_linear)."""
    def sk(i):
        return None if sr_key is None else fold_in(sr_key, 200 + i)
    h = forward_density(params, cfg, input_pts, compute_dtype, fast_grads,
                        sr_key)
    if cfg.use_viewdirs:
        alpha = _dense(params['alpha_linear'], h, compute_dtype,
                       fast_grads and not alpha_f32,
                       None if alpha_f32 else sk(0))
        rgb = forward_view(params, cfg, input_views, h, framecodes,
                           compute_dtype, fast_grads, sr_key)
        return torch.cat([rgb, alpha], -1)
    return _dense(params['output_linear'], h, compute_dtype, fast_grads,
                  sk(1))
