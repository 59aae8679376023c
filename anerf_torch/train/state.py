"""TrainState, flat-vector Adam and the tree helpers around it (torch port
of anerf_tpu/train/state.py).

The JAX package runs both optimizers over ONE flattened vector built by
`jax.flatten_util.ravel_pytree`. `flatten_tree` flattens in the same
order (dict keys sorted, lists in order, None skipped, each leaf
row-major), so a flat parameter, gradient or moment vector carries
across one to one. `FlatAdam` is `optax.adam(b1=0.9, b2=0.999, eps=1e-8)`
under a learning-rate schedule, written out in plain torch: per-leaf
`torch.optim.Adam` has no flat-state contract. As in optax, the schedule
is evaluated at the count BEFORE the update increments it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState over one flat vector; `count` is a host
    integer (the update count)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass
class TrainState:
    step: int                                # host integer
    params: Dict[str, Any]                   # {'coarse','fine','cutoff_dist'}
    opt_state: AdamState
    pose_params: Optional[Dict[str, Any]]    # {'pelvis','bones',...} or None
    pose_opt_state: Optional[AdamState]
    pose_grad_acc: Optional[torch.Tensor]    # flat, like pose_params
    anchors: Optional[Dict[str, Any]]        # {'kps','bones','rots'}


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in ravel_pytree order: dict keys sorted, lists in order,
    None skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def flatten_tree(tree: Any) -> torch.Tensor:
    """The tree as one flat f32 vector, in ravel_pytree order."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def unflatten_like(flat: torch.Tensor, tree: Any) -> Any:
    """The inverse of flatten_tree against a template tree. The leaves
    are views of `flat`, so gradients reach `flat` directly."""
    pos = [0]

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        n = t.numel()
        out = flat[pos[0]:pos[0] + n].view(t.shape)
        pos[0] += n
        return out
    out = build(tree)
    if pos[0] != flat.numel():
        raise ValueError(f'flat vector of {flat.numel()} values for a tree '
                         f'of {pos[0]}')
    return out


def decay_schedule(lrate: float, lrate_decay: int, decay_rate: float,
                   decay_unit: int) -> Callable[[int], float]:
    """LR schedule of reference decay_optimizer_lrate (core/trainer.py:
    173-183): lr = lrate * rate^((count // unit) / decay), in float32 as
    the JAX package computes it. Decay happens in steps of decay_unit."""
    f32 = np.float32

    def sched(count: int) -> float:
        unit_count = f32(int(count) // int(decay_unit))
        return float(f32(lrate) * f32(decay_rate)
                     ** (unit_count / f32(lrate_decay)))
    return sched


class FlatAdam:
    """optax.adam(schedule, b1, b2, eps) over one flat f32 vector, then
    an optional 0/1 `freeze_mask` on the update (the JAX package chains
    `zero_frozen` after Adam)."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 freeze_mask: Optional[torch.Tensor] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.freeze_mask = freeze_mask

    def init(self, flat: torch.Tensor) -> AdamState:
        return AdamState(count=0, mu=torch.zeros_like(flat),
                         nu=torch.zeros_like(flat))

    def update(self, g: torch.Tensor, state: AdamState
               ) -> Tuple[torch.Tensor, AdamState]:
        """(updates, new state) for gradient g; params + updates is the
        stepped vector."""
        b1, b2, f32 = self.b1, self.b2, np.float32
        mu = (1.0 - b1) * g + b1 * state.mu
        nu = (1.0 - b2) * (g * g) + b2 * state.nu
        count = state.count + 1
        c1 = float(f32(1.0) - f32(b1) ** count)
        c2 = float(f32(1.0) - f32(b2) ** count)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
        upd = upd * -self.schedule(state.count)
        if self.freeze_mask is not None:
            upd = upd * self.freeze_mask
        return upd, AdamState(count=count, mu=mu, nu=nu)


def freeze_mask_flat(params: Dict[str, Any], fix_layer: int
                     ) -> torch.Tensor:
    """Flat 0/1 mask over the flattened params: 0 on the first
    `fix_layer` density-trunk layers of every network (reference
    fix_layer finetune freezing, core/raycasters.py:215-217), 1 elsewhere.
    """
    def ones(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: ones(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [ones(v) for v in t]
        return torch.ones_like(t, dtype=torch.float32)
    mask = ones(params)
    for net in mask.values():
        if isinstance(net, dict) and 'pts_linears' in net:
            layers = net['pts_linears']
            for i in range(min(int(fix_layer), len(layers))):
                layers[i] = {k: torch.zeros_like(v)
                             for k, v in layers[i].items()}
    return flatten_tree(mask)


def make_nerf_optimizer(lrate: float, lrate_decay: int, decay_rate: float,
                        decay_unit: int,
                        freeze_mask: Optional[torch.Tensor] = None
                        ) -> FlatAdam:
    return FlatAdam(decay_schedule(lrate, lrate_decay, decay_rate,
                                   decay_unit), freeze_mask=freeze_mask)


def make_pose_optimizer(lrate: float, lrate_decay: int, decay_rate: float,
                        decay_unit: int) -> FlatAdam:
    return FlatAdam(decay_schedule(lrate, lrate_decay, decay_rate,
                                   decay_unit))


def init_opt_state(optimizer: FlatAdam, params: Dict[str, Any]
                   ) -> AdamState:
    """Optimizer state over the flattened param vector."""
    return optimizer.init(flatten_tree(params))


def init_pose_opt_state(pose_optimizer: FlatAdam,
                        pose_params: Dict[str, Any]
                        ) -> Tuple[AdamState, torch.Tensor]:
    """(opt_state, grad_acc) over the flattened pose vector."""
    flat = flatten_tree(pose_params)
    return pose_optimizer.init(flat), torch.zeros_like(flat)


def grad_norms(tree: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total_norm, avg_norm) as in reference get_gradnorm
    (trainer.py:191-203): avg over per-tensor norms."""
    leaves = tree_leaves(tree)
    if not leaves:
        z = torch.zeros(())
        return z, z
    sq = torch.stack([torch.sum(torch.square(x)) for x in leaves])
    return torch.sqrt(torch.sum(sq)), torch.sqrt(torch.sum(sq) / len(leaves))
