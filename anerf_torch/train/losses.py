"""Loss functions (torch port of anerf_tpu/train/losses.py; reference
core/trainer.py:8-61, 147-170)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x) / math.log(10.0)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    m = torch.tensor([[0.299, 0.587, 0.114],
                      [-0.14713, -0.28886, 0.436],
                      [0.615, -0.51499, -0.10001]], dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb[..., None, :] * m).sum(-1)         # rgb @ m.T, exact fp32


def _reduce(d, reduction):
    if reduction == 'mean':
        return torch.mean(d)
    if reduction == 'sum':
        return torch.sum(d)
    return d


def img2mse(x, y, reduction='mean'):
    return _reduce((x - y) ** 2, reduction)


def img2l1(x, y, reduction='mean'):
    return _reduce(torch.abs(x - y), reduction)


def img2huber(x, y, reduction='mean', beta=0.1):
    d = torch.abs(x - y)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _reduce(loss, reduction)


def img2psnr(img, target):
    return mse2psnr(img2mse(img, target))


def acc2bce(x, y, reduction='mean', eps=1e-8, n_off=None):
    """BCE between accumulated alpha and the fg mask; reduction 'off'
    averages only over non-foreground pixels (trainer.py:44-54): over
    `n_off` of them when given (a data-parallel rank's block divides by
    the whole batch's count), else over this batch's."""
    bce = -(y * torch.log(x + eps) + (1.0 - y) * torch.log(1.0 - x + eps))
    if reduction == 'off':
        mask = (y < 1.0).to(bce.dtype)
        if n_off is None:
            n_off = torch.sum(mask)
        return torch.sum(bce * mask) / torch.clamp_min(n_off, 1.0)
    return _reduce(bce, reduction)


def get_loss_fn(loss_name: str, beta: float = 0.1) -> Callable:
    if loss_name == 'MSE':
        return img2mse
    if loss_name == 'L1':
        return img2l1
    if loss_name == 'Huber':
        return lambda x, y, reduction='mean': img2huber(x, y, reduction, beta)
    raise NotImplementedError(loss_name)


def get_reg_fn(reg_name: Optional[str]) -> Optional[Callable]:
    if reg_name is None:
        return None
    if reg_name == 'L1':
        return img2l1
    if reg_name == 'MSE':
        return img2mse
    if reg_name == 'BCE':
        return acc2bce
    raise NotImplementedError(reg_name)
