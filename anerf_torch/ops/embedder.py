"""Positional encoding with distance-based cutoff windows, torch (port of
anerf_tpu/ops/embedder.py).

Output layout matches the JAX package (and the reference) exactly: blocks
of width D ordered [input, sin f0, cos f0, sin f1, cos f1, ...] along the
last axis. Library sin/cos of f32 arguments. Every window mode of the JAX
package: `cutoff_inputs` or not, no include block, `dist_inputs`,
`cut_to_cutoff`, `shift_inputs`, `normalize` and the coarse-to-fine
frequency schedule (`alpha`). The numerics arguments select the JAX
package's custom backwards, as autograd Functions: `out_dtype` (fast_pe)
emits sin/cos in bf16 with a bf16 backward (`_SinCosPE`); `hifi_dtype` /
`remat_dtype` (hifi_pe / remat_pe) keep the default f32 forward, cast
once at emission, and recompute sin/cos in a bf16 / f32 backward that
keeps only the small inputs (`_WindowPE`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Static embedder configuration (same fields as the JAX package)."""
    input_dims: int
    num_freqs: int                       # 'multires'
    include_input: bool = True
    log_sampling: bool = True
    cutoff: bool = False
    cutoff_dim: int = 24
    cutoff_inputs: bool = False
    dist_inputs: bool = False
    cut_to_cutoff: bool = False
    shift_inputs: bool = False
    normalize: bool = False
    freq_schedule: bool = False
    init_alpha: float = 0.0
    init_tau: float = 20.0

    @property
    def max_freq_log2(self) -> float:
        return float(self.num_freqs - 1)

    @property
    def out_dim(self) -> int:
        d = self.input_dims
        out = d if self.include_input else 0
        return out + 2 * self.num_freqs * d

    @property
    def expand(self) -> int:
        """How many input channels share one joint distance."""
        if not self.dist_inputs:
            return 1
        if self.input_dims % self.cutoff_dim:
            raise ValueError('input_dims must be a multiple of cutoff_dim')
        return self.input_dims // self.cutoff_dim

    def freq_bands(self) -> np.ndarray:
        if self.num_freqs == 0:
            return np.zeros((0,), dtype=np.float32)
        if self.log_sampling:
            return (2.0 ** np.linspace(0.0, self.max_freq_log2,
                                       self.num_freqs)).astype(np.float32)
        return np.linspace(2.0 ** 0.0, 2.0 ** self.max_freq_log2,
                           self.num_freqs).astype(np.float32)

    def freq_k(self) -> np.ndarray:
        """log2 of freq bands repeated for (sin, cos): shape (NF, 2)."""
        fb = self.freq_bands()
        return np.log2(np.maximum(fb, 1e-30))[:, None].repeat(2, 1).astype(
            np.float32)


def tau_schedule(cfg: EmbedConfig, global_step: int, cutoff_step: int,
                 cutoff_rate: float) -> float:
    """tau = init_tau * rate^(step / (cutoff_step * 1000)), clamped at
    2000 (reference cutoff_embedder.py:181-183). The step is a host
    integer; the arithmetic is float32, as in the JAX package."""
    f32 = np.float32
    with np.errstate(over='ignore'):      # inf, then the clamp
        tau = f32(cfg.init_tau) * f32(cutoff_rate) ** (
            f32(global_step) / f32(cutoff_step * 1000))
    return float(min(tau, f32(2000.0)))


def alpha_schedule(cfg: EmbedConfig, global_step: int, alpha_step: int,
                   target: Optional[float] = None) -> float:
    """Linear BARF-style coarse-to-fine alpha (cutoff_embedder.py:185-190),
    float32 arithmetic on a host step."""
    if target is None:
        target = float(np.max(cfg.freq_k())) if cfg.num_freqs else 0.0
    f32 = np.float32
    return float(f32(cfg.init_alpha) + (f32(target) - f32(cfg.init_alpha))
                 * f32(global_step) / f32(alpha_step * 1000))


def _schedule_w(cfg: EmbedConfig, alpha, device=None
                ) -> Optional[torch.Tensor]:
    """Per-(freq, fn) window of the frequency schedule, (2*NF, 1) f-major
    (sin, cos) pairs: 0.5 (1 - cos(pi clip(alpha - k, 0, 1))) for band
    log2 k. None where the JAX package multiplies by ones."""
    if not cfg.freq_schedule or alpha is None or cfg.num_freqs == 0:
        return None
    freq_k = torch.as_tensor(cfg.freq_k(), device=device)
    diff = torch.clamp(alpha - freq_k, 0.0, 1.0)
    w = 0.5 * (1.0 - torch.cos(math.pi * diff))
    return w.reshape(-1, 1)


def _pe_rows(sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """(..., NF, D) sin / cos -> (..., 2NF, D) rows [sin f0, cos f0, ...]."""
    emb = torch.stack([sin, cos], dim=-2)
    return emb.reshape(*emb.shape[:-3], 2 * emb.shape[-3], emb.shape[-1])


def _cat_input(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """[x, emb rows] along the row axis, both broadcast to one batch shape
    (view encodings are (R, 1, D) while windows are (R, S, 1, D))."""
    xb = x[..., None, :]
    batch = torch.broadcast_shapes(xb.shape[:-2], emb.shape[:-2])
    return torch.cat([xb.expand(*batch, *xb.shape[-2:]),
                      emb.expand(*batch, *emb.shape[-2:])], dim=-2)


def _window(emb: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
            include_input: bool, cutoff_inputs: bool) -> torch.Tensor:
    """The window multiply and the raw include block: windowed too with
    cutoff_inputs, appended unwindowed without it, absent without
    include_input."""
    if include_input and cutoff_inputs:
        return _cat_input(x, emb) * w
    if include_input:
        return _cat_input(x, emb * w)
    return emb * w


class _SinCosPE(torch.autograd.Function):
    """sin / cos of f32 arguments emitted in out_dtype (fast_pe; the JAX
    package's `_make_sincos_pe`). Backward: sin / cos recomputed in
    out_dtype, the (..., NF, D) cotangent math in out_dtype, and only the
    band reduction accumulated in f32."""

    @staticmethod
    def forward(ctx, x, fb, out_dtype):
        ctx.save_for_backward(x, fb)
        ctx.out_dtype = out_dtype
        arg = fb[:, None] * x[..., None, :]
        return torch.sin(arg).to(out_dtype), torch.cos(arg).to(out_dtype)

    @staticmethod
    def backward(ctx, cot_s, cot_c):
        x, fb = ctx.saved_tensors
        dt = ctx.out_dtype
        arg = fb[:, None] * x[..., None, :]
        s, c = torch.sin(arg).to(dt), torch.cos(arg).to(dt)
        g_arg = cot_s * c - cot_c * s
        gx = (g_arg.float() * fb.to(dt).float()[:, None]).sum(-2)
        return gx.to(x.dtype), None, None


class _WindowPE(torch.autograd.Function):
    """The cutoff-windowed PE with the default f32 forward emitted once in
    out_dtype, bit for bit the default chain followed by the cast, and a
    backward that recomputes sin / cos from the saved (x_freq, x_raw, w)
    (the JAX package's `_make_window_pe`). The wide cotangent math runs
    in bwd_dtype: bf16 for hifi_pe, f32 for remat_pe (the default's
    values up to summation order). The window and band reductions
    accumulate in f32, and every gradient is reduced to its primal's
    (broadcast) shape."""

    @staticmethod
    def forward(ctx, x_freq, x_raw, w, fb, include_input, cutoff_inputs,
                out_dtype, bwd_dtype):
        ctx.save_for_backward(x_freq, x_raw, w, fb)
        ctx.flags = (include_input, cutoff_inputs, bwd_dtype)
        # embed's default ops in their order, then the one cast
        arg = fb[:, None] * x_freq[..., None, :]
        emb = _pe_rows(torch.sin(arg), torch.cos(arg))
        return _window(emb, x_raw, w, include_input,
                       cutoff_inputs).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x_freq, x_raw, w, fb = ctx.saved_tensors
        include_input, cutoff_inputs, bd = ctx.flags
        g = g.to(bd)
        w_b = w.to(bd)
        arg = fb[:, None] * x_freq[..., None, :]
        s, c = torch.sin(arg).to(bd), torch.cos(arg).to(bd)
        emb_b = _pe_rows(s, c)

        def rowdot(a, b):        # sum over rows, f32 accumulation
            return (a.float() * b.float()).sum(-2)[..., None, :]

        if include_input and cutoff_inputs:
            g_cat = g * w_b
            xb = x_raw[..., None, :].to(bd)
            gw = (g[..., :1, :] * xb).float().sum(-2, keepdim=True)
            gw = gw + rowdot(g[..., 1:, :], emb_b)
            g_raw, g_freq = g_cat[..., 0, :], g_cat[..., 1:, :]
        elif include_input:
            g_raw, g_fw = g[..., 0, :], g[..., 1:, :]
            gw = rowdot(g_fw, emb_b)
            g_freq = g_fw * w_b
        else:
            g_raw = None
            gw = rowdot(g, emb_b)
            g_freq = g * w_b
        gp = g_freq.reshape(*g_freq.shape[:-2], -1, 2, g_freq.shape[-1])
        g_arg = gp[..., 0, :] * c - gp[..., 1, :] * s
        gx_freq = (g_arg.float() * fb.to(bd).float()[:, None]).sum(-2)
        gx_freq = gx_freq.sum_to_size(x_freq.shape).to(x_freq.dtype)
        g_raw = (torch.zeros_like(x_raw) if g_raw is None else
                 g_raw.float().sum_to_size(x_raw.shape).to(x_raw.dtype))
        gw = gw.sum_to_size(w.shape).to(w.dtype)
        return gx_freq, g_raw, gw, None, None, None, None, None


def embed(cfg: EmbedConfig, inputs: torch.Tensor,
          dists: Optional[torch.Tensor] = None,
          cutoff_dist: Optional[torch.Tensor] = None,
          tau=None, alpha=None,
          out_dtype: Optional[torch.dtype] = None,
          hifi_dtype: Optional[torch.dtype] = None,
          remat_dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply the (cutoff) positional encoding.

    inputs (..., D); dists (..., cutoff_dim) per-joint distances;
    cutoff_dist (cutoff_dim,); alpha the frequency schedule's value (or
    None). Returns (embedded (..., out_dim), window). `inputs` may carry
    broadcast batch dims (view encodings are (R, 1, D) while dists are
    (R, S, J)). out_dtype: sin / cos emitted in it (their arguments stay
    f32) with a low-precision backward. hifi_dtype / remat_dtype (without
    out_dtype, freq_schedule or normalize): the f32 forward emitted once
    in that dtype, with a rematerialized bf16 / f32 backward.
    """
    if not cfg.cutoff:
        return _embed_plain(cfg, inputs), None
    if dists is None or cutoff_dist is None or tau is None:
        raise ValueError('cutoff embedding needs dists, cutoff_dist and tau')

    NF = cfg.num_freqs
    fb = torch.as_tensor(cfg.freq_bands(), device=inputs.device)
    if cfg.dist_inputs:
        e = cfg.expand
        dists_e = dists.repeat_interleave(e, dim=-1)
        cut_e = cutoff_dist.repeat_interleave(e, dim=-1)
        x = x_freq = inputs
        v = tau * (dists_e - cut_e)
    else:
        # the inputs are the per-joint distances themselves; the shift
        # moves only the frequency inputs, the include block stays as it is
        x = inputs
        if cfg.cut_to_cutoff:
            x = cutoff_dist - x
        x_freq = x * (2.0 / cutoff_dist) - 1.0 if cfg.shift_inputs else x
        v = tau * (inputs - cutoff_dist)
    w = 1.0 - torch.sigmoid(v)[..., None, :]                  # (..., 1, D)

    emit = hifi_dtype if hifi_dtype is not None else remat_dtype
    if (emit is not None and out_dtype is None and not cfg.freq_schedule
            and not cfg.normalize and NF > 0):
        bwd = hifi_dtype if hifi_dtype is not None else torch.float32
        emb = _WindowPE.apply(x_freq, x, w, fb, cfg.include_input,
                              cfg.cutoff_inputs, emit, bwd)
        return emb.reshape(*emb.shape[:-2], -1), w

    w_f32 = w
    if out_dtype is not None:
        w = w.to(out_dtype)
        x = x.to(out_dtype)
        emb = _pe_rows(*_SinCosPE.apply(x_freq, fb, out_dtype))
    else:
        arg = fb[:, None] * x_freq[..., None, :]
        emb = _pe_rows(torch.sin(arg), torch.cos(arg))
    sched = _schedule_w(cfg, alpha, inputs.device)
    if sched is not None:
        emb = emb * sched.to(emb.dtype)
    emb = _window(emb, x, w, cfg.include_input, cfg.cutoff_inputs)

    if cfg.normalize:
        # each consecutive 3-vector to unit length, zero where the window
        # is closed; the mask is taken on the f32 window, before any cast
        sh = emb.shape
        e3 = emb.reshape(-1, 3)
        e3 = e3 / torch.clamp_min(
            torch.linalg.vector_norm(e3, dim=-1, keepdim=True), 1e-12)
        closed = w_f32.abs() <= 1e-6
        emb = torch.where(closed, torch.zeros((), dtype=emb.dtype,
                                              device=emb.device),
                          e3.reshape(sh))
    return emb.reshape(*emb.shape[:-2], -1), w


def _embed_plain(cfg: EmbedConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Classic NeRF PE: [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]."""
    parts = []
    if cfg.include_input:
        parts.append(inputs)
    for f in cfg.freq_bands():
        parts.append(torch.sin(inputs * float(f)))
        parts.append(torch.cos(inputs * float(f)))
    if not parts:
        return inputs[..., :0]
    return torch.cat(parts, dim=-1)


def make_embedder(multires: int, input_dims: int = 3, i_embed: int = 0,
                  cutoff_kwargs: Optional[dict] = None
                  ) -> Tuple[Optional[EmbedConfig], int]:
    """Returns (EmbedConfig or None for identity, out_dim)."""
    if i_embed == -1:
        return None, input_dims
    kwargs = dict(input_dims=input_dims, num_freqs=multires,
                  include_input=True, log_sampling=True)
    if cutoff_kwargs and cutoff_kwargs.get('cutoff', False):
        ck = dict(cutoff_kwargs)
        ck.pop('cutoff', None)
        ck.pop('cutoff_dist', None)
        ck.pop('opt_cutoff', None)
        if 'normalize_cutoff' in ck:
            ck['normalize'] = ck.pop('normalize_cutoff')
        cfg = EmbedConfig(cutoff=True, **kwargs, **ck)
    else:
        cfg = EmbedConfig(cutoff=False, **kwargs)
    return cfg, cfg.out_dim
