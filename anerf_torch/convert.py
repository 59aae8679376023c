"""Carry parameter trees and train states between the JAX package and
the port.

Both packages use the same tree ({'coarse', 'fine', 'cutoff_dist'}, MLP
weights as (in, out)), so conversion is a leaf-by-leaf copy. Both run
their optimizers over flat vectors in the same order (train/state.py),
so Adam moments and pose-gradient accumulators copy across as they are.
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


def _field(state: Any, name: str) -> Any:
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _adam_arrays(opt_state: Any):
    """(count, mu, nu) of the Adam state inside an optimizer state: an
    optax state (its ScaleByAdamState, found by its mu / nu fields inside
    the chain's tuples) or the {'count', 'mu', 'nu'} dict of
    train_state_to_numpy. None if there is none."""
    if opt_state is None:
        return None
    if isinstance(opt_state, dict):
        return opt_state['count'], opt_state['mu'], opt_state['nu']
    if hasattr(opt_state, 'mu') and hasattr(opt_state, 'nu'):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_arrays(s)
            if found is not None:
                return found
    return None


def train_state_from_numpy(state: Any, device='cuda'):
    """A train state with numpy leaves -> the port's TrainState on
    `device`. `state` is a JAX TrainState after
    `jax.tree.map(np.asarray, state)` (optax Adam states over the flat
    vectors, which the port's FlatAdam continues one to one) or the dict
    of train_state_to_numpy."""
    from .train.state import AdamState, TrainState
    dev = resolve_device(device)

    def adam(opt_state):
        found = _adam_arrays(opt_state)
        if found is None:
            return None
        count, mu, nu = found
        return AdamState(count=int(np.asarray(count)),
                         mu=params_from_numpy(mu, dev),
                         nu=params_from_numpy(nu, dev))

    return TrainState(
        step=int(np.asarray(_field(state, 'step'))),
        params=params_from_numpy(_field(state, 'params'), dev),
        opt_state=adam(_field(state, 'opt_state')),
        pose_params=params_from_numpy(_field(state, 'pose_params'), dev),
        pose_opt_state=adam(_field(state, 'pose_opt_state')),
        pose_grad_acc=params_from_numpy(_field(state, 'pose_grad_acc'),
                                        dev),
        anchors=params_from_numpy(_field(state, 'anchors'), dev))


def train_state_to_numpy(state: Any) -> dict:
    """The port's TrainState -> a dict of numpy arrays (each Adam state
    as {'count', 'mu', 'nu'}); train_state_from_numpy takes it back."""
    def adam(s):
        if s is None:
            return None
        return {'count': int(s.count), 'mu': params_to_numpy(s.mu),
                'nu': params_to_numpy(s.nu)}
    return {'step': int(state.step),
            'params': params_to_numpy(state.params),
            'opt_state': adam(state.opt_state),
            'pose_params': params_to_numpy(state.pose_params),
            'pose_opt_state': adam(state.pose_opt_state),
            'pose_grad_acc': params_to_numpy(state.pose_grad_acc),
            'anchors': params_to_numpy(state.anchors)}
