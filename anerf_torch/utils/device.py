"""The card's numerics settings, in one place, and its name.

XLA sums the products of bf16 matmuls in f32 and runs f32 matmuls at f32
(`precision='highest'` where it matters). PyTorch's defaults on a GPU
differ in one of them: cuBLAS may sum bf16 products in reduced precision
(`allow_bf16_reduced_precision_reduction` is True by default), and TF32
may be switched on by a caller. `card_settings` turns both off.
`anerf_torch.resolve_device` calls it whenever it resolves a CUDA device,
and every run on the card (the entry points, the ranks they spawn, the
tools, `chip_smoke.py`) resolves its device there, so a user's run has
the numerics the card's gates were held under. `card_line` names the
card and its power limit, which the tools print beside their numbers.
"""
from __future__ import annotations

import subprocess
from typing import Dict

import torch


def card_settings() -> Dict[str, bool]:
    """TF32 off (matmuls and cuDNN), cuBLAS's bf16 sums in f32. The flags
    are the process's own and only CUDA reads them, so setting them on a
    CPU run changes nothing. Returns the settings now in force."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return settings_in_force()


def settings_in_force() -> Dict[str, bool]:
    """The three flags as they stand."""
    m = torch.backends.cuda.matmul
    return {'tf32_matmul': m.allow_tf32,
            'tf32_cudnn': torch.backends.cudnn.allow_tf32,
            'bf16_reduced_precision_reduction':
                m.allow_bf16_reduced_precision_reduction}


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
