"""Checkpoint save / restore (torch port of anerf_tpu/train/checkpoint.py).

The logical contents mirror the reference's monolithic .tar (SURVEY §5):
global_step, NeRF params (coarse/fine), embedder state (cutoff_dist; tau is
derived from step), both optimizer states, pose params + pose optimizer +
anchors. The JAX package writes them with orbax; the port writes one
torch file, `state.pt`, of the same tree (convert.train_state_to_numpy's
dict, its arrays as CPU tensors) per step directory:
exp_dir/checkpoints/<step>/, the newest `keep` kept. Auto-resume picks the
newest step (reference raycasters.py:124-142); `finetune` loads weights
but resets step/optimizer (cutoff_embedder.py:233-236). Pose-only
snapshots are .npz files with the JAX package's key names, so either
package's `load_pose_checkpoint` reads either's.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..convert import params_to_numpy
from .state import AdamState, TrainState

STATE_FILE = 'state.pt'


def _ckpt_dir(exp_dir: str) -> str:
    return os.path.join(os.path.abspath(exp_dir), 'checkpoints')


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(path, d, STATE_FILE)))


def _to_cpu(tree: Any) -> Any:
    if tree is None or isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().to('cpu', copy=True)


def _adam_tree(s: Optional[AdamState]):
    if s is None:
        return None
    return {'count': int(s.count), 'mu': s.mu, 'nu': s.nu}


def state_tree(state: TrainState) -> dict:
    """The train state as the checkpoint's tree (tensors on the CPU)."""
    return _to_cpu({
        'step': int(state.step), 'params': state.params,
        'opt_state': _adam_tree(state.opt_state),
        'pose_params': state.pose_params,
        'pose_opt_state': _adam_tree(state.pose_opt_state),
        'pose_grad_acc': state.pose_grad_acc, 'anchors': state.anchors})


def save_checkpoint(exp_dir: str, state: TrainState, step: int,
                    keep: int = 3) -> str:
    """Write `state` as exp_dir/checkpoints/<step>/state.pt (a whole
    directory renamed into place), then remove all but the newest `keep`
    steps. Returns the step directory."""
    path = _ckpt_dir(exp_dir)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
    tmp = f'{final}.tmp{os.getpid()}'
    os.makedirs(tmp)
    torch.save(state_tree(state), os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, str(old)))
    return final


def latest_checkpoint_step(exp_dir: str) -> Optional[int]:
    steps = _steps(_ckpt_dir(exp_dir))
    return steps[-1] if steps else None


def _load(path: str, step: int) -> dict:
    return torch.load(os.path.join(path, str(step), STATE_FILE),
                      map_location='cpu', weights_only=True)


def _merge(target: Any, loaded: Any, what: str, where: str) -> Any:
    """`loaded` in the structure, dtype and device of `target`."""
    if target is None:
        return None
    if loaded is None:
        raise ValueError(f'{where}: the checkpoint has no {what}, which '
                         f'this run\'s model config needs')
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise ValueError(f'{where}: checkpoint {what} tree does not '
                             f'match this run\'s model config')
        return {k: _merge(target[k], loaded[k], what, where)
                for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) \
                or len(loaded) != len(target):
            raise ValueError(f'{where}: checkpoint {what} tree does not '
                             f'match this run\'s model config')
        return [_merge(t, v, what, where) for t, v in zip(target, loaded)]
    if tuple(loaded.shape) != tuple(target.shape):
        raise ValueError(f'{where}: checkpoint {what} leaf of shape '
                         f'{tuple(loaded.shape)} where this run has '
                         f'{tuple(target.shape)}')
    return loaded.to(device=target.device, dtype=target.dtype)


def _merge_adam(target: Optional[AdamState], loaded, where: str
                ) -> Optional[AdamState]:
    if target is None:
        return None
    if loaded is None:
        raise ValueError(f'{where}: the checkpoint has no optimizer state, '
                         f'which this run\'s model config needs')
    return AdamState(count=int(loaded['count']),
                     mu=_merge(target.mu, loaded['mu'], 'optimizer', where),
                     nu=_merge(target.nu, loaded['nu'], 'optimizer', where))


def restore_checkpoint(exp_dir: str, target: TrainState,
                       step: Optional[int] = None) -> Optional[TrainState]:
    """The checkpoint of `step` (the newest by default) in the structure,
    dtypes and device of `target`; None when there is none."""
    path = _ckpt_dir(exp_dir)
    step = step if step is not None else latest_checkpoint_step(exp_dir)
    if step is None:
        return None
    raw = _load(path, step)
    where = os.path.join(path, str(step))
    return TrainState(
        step=int(raw['step']),
        params=_merge(target.params, raw['params'], 'params', where),
        opt_state=_merge_adam(target.opt_state, raw['opt_state'], where),
        pose_params=_merge(target.pose_params, raw['pose_params'],
                           'pose_params', where),
        pose_opt_state=_merge_adam(target.pose_opt_state,
                                   raw['pose_opt_state'], where),
        pose_grad_acc=_merge(target.pose_grad_acc, raw['pose_grad_acc'],
                             'pose_grad_acc', where),
        anchors=_merge(target.anchors, raw['anchors'], 'anchors', where))


def restore_from_path(path: str, target: TrainState
                      ) -> Optional[TrainState]:
    """Restore from an explicit path (--ft_path, reference
    raycasters.py:125-126: ft_path replaces the expdir ckpt search).

    Accepts an experiment dir (containing checkpoints/), a checkpoints
    dir, a specific step dir, or a reference torch .tar. Weights only:
    the step and the params (and pose params / anchors when this run has
    them) come from the checkpoint, the optimizer states stay `target`'s.
    A .tar's params replace `target`'s whole, on its device, as the JAX
    package replaces them.
    """
    if path.endswith('.tar'):
        from ..convert import params_from_numpy
        from ..pose.ckpt_compat import load_reference_checkpoint
        params, extras = load_reference_checkpoint(path)
        return dataclasses.replace(
            target, step=int(extras.get('global_step') or 0),
            params=params_from_numpy(
                params, target.params['cutoff_dist'].device))
    p = os.path.abspath(path)
    step = None
    if os.path.basename(p).isdigit():
        step, p = int(os.path.basename(p)), os.path.dirname(p)
    elif os.path.isdir(os.path.join(p, 'checkpoints')):
        p = os.path.join(p, 'checkpoints')
    if not os.path.isdir(p):
        raise FileNotFoundError(f'--ft_path checkpoint not found: {path}')
    if step is None:
        steps = _steps(p)
        if not steps:
            return None
        step = steps[-1]
    raw = _load(p, step)
    where = f'--ft_path {path}'
    out = dataclasses.replace(
        target, step=int(raw['step']),
        params=_merge(target.params, raw['params'], 'params', where))
    if target.pose_params is not None and raw.get('pose_params') is not None:
        out = dataclasses.replace(
            out,
            pose_params=_merge(target.pose_params, raw['pose_params'],
                               'pose_params', where),
            anchors=_merge(target.anchors, raw['anchors'], 'anchors', where))
    return out


def save_pose_checkpoint(exp_dir: str, state: TrainState, step: int) -> str:
    """Pose-only snapshot (reference save_popt, trainer.py:508-516)."""
    path = os.path.join(os.path.abspath(exp_dir), 'pose_checkpoints',
                        f'{step:08d}')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        'global_step': step,
        'pose_params': params_to_numpy(state.pose_params),
        'anchors': params_to_numpy(state.anchors),
    }
    np.savez(path + '.npz', **_flatten(payload))
    return path + '.npz'


def _flatten(tree, prefix=''):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}{k}/'))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def load_pose_checkpoint(path: str):
    """Load a pose-only snapshot back into nested dicts."""
    flat = dict(np.load(path))
    out: dict = {}
    for k, v in flat.items():
        parts = k.split('/')
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out

