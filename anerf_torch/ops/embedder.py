"""Positional encoding with distance-based cutoff windows, torch (port of
anerf_tpu/ops/embedder.py for the modes the flagship uses).

Output layout matches the JAX package (and the reference) exactly: blocks
of width D ordered [input, sin f0, cos f0, sin f1, cos f1, ...] along the
last axis. Library sin/cos in f32. Ported modes: plain PE, and the cutoff
window with the raw input windowed too (`cutoff_inputs`), with or without
`dist_inputs`. The other branch modes and the custom-backward numerics
knobs raise NotImplementedError until a later slice ports them.
"""
from __future__ import annotations

import dataclasses
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


def embed(cfg: EmbedConfig, inputs: torch.Tensor,
          dists: Optional[torch.Tensor] = None,
          cutoff_dist: Optional[torch.Tensor] = None,
          tau: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply the (cutoff) positional encoding.

    inputs (..., D); dists (..., cutoff_dim) per-joint distances;
    cutoff_dist (cutoff_dim,). Returns (embedded (..., out_dim), window).
    `inputs` may carry broadcast batch dims (view encodings are (R, 1, D)
    while dists are (R, S, J)).
    """
    if not cfg.cutoff:
        return _embed_plain(cfg, inputs), None
    if (cfg.cut_to_cutoff or cfg.shift_inputs or cfg.normalize
            or cfg.freq_schedule or not cfg.cutoff_inputs
            or not cfg.include_input):
        raise NotImplementedError(
            'anerf_torch embed: only the cutoff_inputs window without '
            'cut_to_cutoff / shift_inputs / normalize / freq_schedule is '
            'ported yet')
    if dists is None or cutoff_dist is None or tau is None:
        raise ValueError('cutoff embedding needs dists, cutoff_dist and tau')

    NF = cfg.num_freqs
    fb = torch.as_tensor(cfg.freq_bands(), device=inputs.device)
    if cfg.dist_inputs:
        e = cfg.expand
        dists_e = dists.repeat_interleave(e, dim=-1)
        cut_e = cutoff_dist.repeat_interleave(e, dim=-1)
        v = tau * (dists_e - cut_e)
    else:
        v = tau * (inputs - cutoff_dist)
    w = 1.0 - torch.sigmoid(v)[..., None, :]                  # (..., 1, D)

    arg = fb[:, None] * inputs[..., None, :]                  # (..., NF, D)
    emb = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-2)
    emb = emb.reshape(*emb.shape[:-3], 2 * NF, emb.shape[-1])
    emb = torch.cat([inputs[..., None, :], emb], dim=-2)      # (..., K, D)
    emb = emb * w
    return emb.reshape(*emb.shape[:-2], emb.shape[-2] * emb.shape[-1]), w


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
