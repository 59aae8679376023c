"""anerf_torch: the PyTorch / CUDA (H100) port of anerf_tpu.

Mirrors anerf_tpu's layout (ops/, models/, render/, kernels/) so each
module's counterpart is easy to find. Imports torch, numpy and scipy only.
Entry points run on the GPU unless the caller passes device='cpu'.
"""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """The device an entry point runs on. 'cuda' (the default everywhere)
    raises when no GPU is present: the port never falls back to the CPU
    unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "anerf_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
