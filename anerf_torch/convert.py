"""Carry parameter trees between the JAX package and the port.

Both packages use the same tree ({'coarse', 'fine', 'cutoff_dist'}, MLP
weights as (in, out)), so conversion is a leaf-by-leaf copy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device


def params_from_numpy(tree: Any, device='cuda') -> Any:
    """A tree of numpy arrays (e.g. a JAX param tree after
    `jax.tree.map(np.asarray, params)`) -> the same tree of torch tensors
    on `device`. None leaves stay None; lists stay lists."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.as_tensor(np.array(x, copy=True)).to(dev)
    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: a tree of torch tensors -> numpy arrays on the host."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
