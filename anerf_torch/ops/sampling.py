"""Ray sampling: stratified, inverse-CDF importance, coarse/fine merge
(torch port of anerf_tpu/ops/sampling.py).

The JAX package computes ranks by a dense compare and gathers by one-hot
matmuls because the TPU lowers sort and gather badly; here the same
functions are a stable sort, `torch.searchsorted` and `torch.gather`.
Randomness draws from an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_from_lineseg(near: torch.Tensor, far: torch.Tensor,
                        n_samples: int, perturb: float = 0.0,
                        lindisp: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Stratified samples along [near, far]; near/far (R, 1) ->
    z_vals (R, n_samples). perturb > 0 jitters each sample in its stratum."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                            device=near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)

    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        t_rand = torch.rand(z_vals.shape, generator=generator,
                            dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling: bins (R, M) midpoints, weights (R, M-1).
    Returns samples (R, n_samples)."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype,
                       device=cdf.device)

    # the count of cdf entries <= u (the JAX dense compare-and-count)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    pad = cdf.shape[-1] - bins.shape[-1]
    binsp = bins if pad == 0 else torch.cat(
        [bins, bins[..., -1:].expand(*bins.shape[:-1], pad)], -1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(binsp, -1, below)
    bins_above = torch.gather(binsp, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def stable_ranks(z: torch.Tensor) -> torch.Tensor:
    """rank[r, k] = position of z[r, k] in the stably sorted row (ties
    broken by original index), i.e. the inverse of the stable argsort."""
    order = torch.sort(z, dim=-1, stable=True).indices
    ranks = torch.empty_like(order)
    ar = torch.arange(z.shape[-1], device=z.device).expand_as(order)
    return ranks.scatter_(-1, order, ar)


def scatter_rows(data: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """out[r, ranks[r, s], ...] = data[r, s, ...] (ranks a per-row
    permutation, e.g. from stable_ranks)."""
    idx = ranks.reshape(ranks.shape + (1,) * (data.dim() - 2))
    idx = idx.expand_as(data)
    return torch.empty_like(data).scatter_(1, idx, data)


def isample_from_lineseg(z_vals: torch.Tensor, weights: torch.Tensor,
                         n_importance: int, det: bool = False,
                         is_only: bool = False, alpha_base: float = 0.01,
                         generator: Optional[torch.Generator] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Importance sampling around existing z_vals.

    Returns (z_all_sorted, z_samples, merge_ranks): merge_ranks are the
    stable sort ranks of the concatenated [z_vals, z_samples]; feed
    per-sample tensors in concat order to `scatter_rows(x, merge_ranks)`
    to reorder them into sorted-z order.
    """
    z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if is_only:
        w_l = weights[..., 0:-2]
        w_k = weights[..., 1:-1]
        w_u = weights[..., 2:]
        dist_weights = 0.5 * (torch.maximum(w_l, w_k)
                              + torch.maximum(w_k, w_u)) + alpha_base
    else:
        dist_weights = weights[..., 1:-1]

    z_samples = sample_pdf(z_vals_mid, dist_weights, n_importance, det=det,
                           generator=generator).detach()
    z_cat = torch.cat([z_vals, z_samples], -1)
    merge_ranks = stable_ranks(z_cat)
    z_all = scatter_rows(z_cat, merge_ranks)
    return z_all, z_samples, merge_ranks
