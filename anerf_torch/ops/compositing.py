"""Volume compositing (raw network outputs -> pixel values), torch
(port of anerf_tpu/ops/compositing.py)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def get_density_fn(density_type: str, softplus_shift: float = 1.0
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Density activation selection."""
    if density_type == 'relu':
        return torch.relu
    if density_type == 'softplus':
        return lambda x: F.softplus(x - softplus_shift)
    raise NotImplementedError(f'density activation {density_type} undefined')


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor,
                raw_noise_std: float = 0.0,
                generator: Optional[torch.Generator] = None,
                density_scale: float = 1.0,
                act_fn: Callable = torch.relu,
                rgb_eps: float = 0.001) -> Dict[str, torch.Tensor]:
    """Alpha-composite raw (R, S, 4) predictions along each ray.

    Returns rgb_map (R, 3), disp_map (R,), acc_map (R,), weights (R, S),
    alpha (R, S), depth_map (R,). Density noise (raw_noise_std > 0) draws
    from `generator`.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3]) * (1 + 2 * rgb_eps) - rgb_eps

    sigma = raw[..., 3] / density_scale
    if raw_noise_std > 0.0:
        noise = torch.randn(sigma.shape, generator=generator,
                            dtype=sigma.dtype, device=sigma.device)
        sigma = sigma + noise * raw_noise_std * density_scale
    alpha = 1.0 - torch.exp(-act_fn(sigma) * dists)

    # T_i = prod_{j<i} (1 - alpha_j + 1e-10): exclusive cumulative product
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]),
                   1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    wsum = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp_min(depth_map / (wsum + 1e-10), 1e-10)
    disp_map = torch.where(torch.isclose(wsum, torch.zeros_like(wsum)),
                           0.0, disp_map)
    acc_map = torch.clamp_max(wsum, 1.0)
    return {'rgb_map': rgb_map, 'disp_map': disp_map, 'acc_map': acc_map,
            'weights': weights, 'alpha': alpha, 'depth_map': depth_map}
