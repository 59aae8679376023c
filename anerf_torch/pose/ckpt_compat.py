"""Import reference PyTorch .tar checkpoints into the port's parameter
trees, and export them back (torch port of anerf_tpu/pose/ckpt_compat.py).

The reference saves a monolithic torch .tar with a legacy key scheme. This
module parses it on the host (tensors on the CPU) into:
  * render params {'coarse', 'fine', 'cutoff_dist'} (weights transposed to
    the (in, out) layout used by models/nerf.py),
  * pose data (kp3d/bones/skts/cyls/rest_pose/pelvis), the equivalent of
    the reference's pose_ckpt_to_pose_data,
so pretrained reference models render without retraining. The trees are
numpy, as the JAX package's are; convert.params_from_numpy puts them on
a device. The exporter takes numpy arrays or torch tensors on any device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..skeleton import SMPLSkeleton


def _load_torch(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location='cpu', weights_only=False)


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear (out, in) -> ours (in, out)."""
    return {'w': _to_np(sd[f'{prefix}.weight']).T.copy(),
            'b': _to_np(sd[f'{prefix}.bias']).copy()}


def nerf_state_dict_to_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """One NeRF module state dict -> our param tree."""
    params: Dict[str, Any] = {'pts_linears': []}
    i = 0
    while f'pts_linears.{i}.weight' in sd:
        params['pts_linears'].append(_linear(sd, f'pts_linears.{i}'))
        i += 1
    for k in ('alpha_linear', 'feature_linear', 'rgb_linear',
              'output_linear'):
        if f'{k}.weight' in sd:
            params[k] = _linear(sd, k)
    if 'views_linears.0.weight' in sd:
        params['views_linears'] = [_linear(sd, 'views_linears.0')]
    if 'framecodes.codes.weight' in sd:
        params['framecodes'] = {
            'codes': _to_np(sd['framecodes.codes.weight']).copy()}
    return params


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Parse a reference training .tar.

    Returns (render_params, extras) where extras carries global_step, the
    embedder tau, and the raw pose state dict (if present).
    """
    ckpt = _load_torch(path)
    params: Dict[str, Any] = {}

    params['coarse'] = nerf_state_dict_to_params(
        ckpt['network_fn_state_dict'])
    params['fine'] = None
    if ckpt.get('network_fine_state_dict'):
        fine_sd = ckpt['network_fine_state_dict']
        if fine_sd:
            params['fine'] = nerf_state_dict_to_params(fine_sd)

    embed_sd = ckpt.get('embed_state_dict', {})
    if 'cutoff_dist' in embed_sd:
        params['cutoff_dist'] = _to_np(embed_sd['cutoff_dist']).copy()
    else:
        params['cutoff_dist'] = np.full((24,), 0.5, np.float32)

    extras = {
        'global_step': int(ckpt.get('global_step', 0)),
        'tau': float(_to_np(embed_sd['tau'])) if 'tau' in embed_sd else None,
        'poseopt_state_dict': ckpt.get('poseopt_layer_state_dict'),
        'poseopt_anchors': ckpt.get('poseopt_anchors'),
    }
    return params, extras


def _t(x) -> torch.Tensor:
    """A leaf as a CPU tensor of its own values (a copy)."""
    return torch.tensor(_to_np(x).copy())


def _params_to_state_dict(params: Dict[str, Any]) -> Dict[str, Any]:
    """Our (in, out) param tree -> torch-layout state dict tensors."""
    sd: Dict[str, Any] = {}
    for i, layer in enumerate(params['pts_linears']):
        sd[f'pts_linears.{i}.weight'] = _t(_to_np(layer['w']).T)
        sd[f'pts_linears.{i}.bias'] = _t(layer['b'])
    for k in ('alpha_linear', 'feature_linear', 'rgb_linear',
              'output_linear'):
        if k in params:
            sd[f'{k}.weight'] = _t(_to_np(params[k]['w']).T)
            sd[f'{k}.bias'] = _t(params[k]['b'])
    if 'views_linears' in params:
        sd['views_linears.0.weight'] = _t(
            _to_np(params['views_linears'][0]['w']).T)
        sd['views_linears.0.bias'] = _t(params['views_linears'][0]['b'])
    if 'framecodes' in params:
        sd['framecodes.codes.weight'] = _t(params['framecodes']['codes'])
    return sd


def export_reference_checkpoint(path: str, params: Dict[str, Any],
                                global_step: int = 0,
                                tau: float = 2000.0,
                                pose_params: Optional[Dict[str, Any]] = None,
                                rest_pose: Optional[np.ndarray] = None,
                                kp_map: Optional[np.ndarray] = None,
                                kp_uidxs: Optional[np.ndarray] = None
                                ) -> None:
    """Write a model as a reference-format torch .tar, so models trained
    here can be consumed by reference tooling (the inverse of
    load_reference_checkpoint, in the reference's key scheme). Poses
    shared across views ('root_bones' (N, ...) beside 'bones' (U, J-1,
    ...)) are written in the reference's multiview form, with the
    kp_map / kp_uidxs tables that must then be given."""
    ckpt: Dict[str, Any] = {
        'global_step': int(global_step),
        'network_fn_state_dict': _params_to_state_dict(params['coarse']),
        'embed_state_dict': {
            'cutoff_dist': _t(params['cutoff_dist']),
            'tau': torch.tensor(float(tau)),
        },
    }
    if params.get('fine') is not None:
        ckpt['network_fine_state_dict'] = _params_to_state_dict(
            params['fine'])
    if pose_params is not None:
        popt_sd = {k: _t(pose_params[k]) for k in
                   ('pelvis', 'root_bones', 'bones') if k in pose_params}
        if 'root_bones' in pose_params:
            if kp_map is None or kp_uidxs is None:
                raise ValueError('shared poses (root_bones) are written '
                                 'with their kp_map and kp_uidxs')
            popt_sd['kp_map'] = torch.as_tensor(np.asarray(kp_map,
                                                           np.int64))
            popt_sd['kp_uidxs'] = torch.as_tensor(np.asarray(kp_uidxs,
                                                             np.int64))
        if rest_pose is not None:
            popt_sd['rest_pose'] = _t(_to_np(rest_pose).reshape(1, -1, 3))
        ckpt['poseopt_layer_state_dict'] = popt_sd
    torch.save(ckpt, path)


def pose_state_dict_to_params(popt_sd: Dict[str, Any]) -> Dict[str, Any]:
    """poseopt_layer_state_dict -> our pose param tree."""
    out = {'pelvis': _to_np(popt_sd['pelvis']).copy(),
           'bones': _to_np(popt_sd['bones']).copy()}
    if 'root_bones' in popt_sd:
        out['root_bones'] = _to_np(popt_sd['root_bones']).copy()
    if 'kp_map' in popt_sd:
        out['kp_map'] = _to_np(popt_sd['kp_map']).copy()
        out['kp_uidxs'] = _to_np(popt_sd['kp_uidxs']).copy()
    if 'rest_pose' in popt_sd:
        out['rest_pose'] = _to_np(popt_sd['rest_pose']).copy()
    return out


def _bones_to_axisang_np(bones: np.ndarray) -> np.ndarray:
    if bones.shape[-1] == 3:
        return bones
    from ..ops.rotations import rot6d_to_axisang
    return rot6d_to_axisang(
        torch.as_tensor(bones, dtype=torch.float32)).numpy()


def pose_ckpt_to_pose_data(path: Optional[str] = None,
                           popt_sd: Optional[Dict[str, Any]] = None,
                           ext_scale: float = 0.001,
                           legacy: bool = False,
                           skel=SMPLSkeleton):
    """Pose checkpoint -> (kp3d, bones, skts, cyls, rest_pose, pelvis)
    (the reference's pose_ckpt_to_pose_data), including the legacy
    axis-swap path."""
    if popt_sd is None:
        ckpt = _load_torch(path)
        popt_sd = ckpt['poseopt_layer_state_dict']
    pp = pose_state_dict_to_params(popt_sd)

    pelvis = pp['pelvis']
    bones = _bones_to_axisang_np(pp['bones'])
    if 'root_bones' in pp and pp['bones'].shape[1] == skel.n_joints - 1:
        roots = _bones_to_axisang_np(pp['root_bones'])[:, None]
        kp_map = pp['kp_map']
        bones = np.concatenate([roots, bones[kp_map]], axis=1)
    rest_pose = pp.get('rest_pose')
    if rest_pose is None:
        raise ValueError('pose ckpt missing rest_pose')
    rest_pose = rest_pose.reshape(-1, skel.n_joints, 3)[0]

    if legacy:
        from scipy.spatial.transform import Rotation
        pelvis = pelvis.copy()
        pelvis[..., 1:] *= -1
        rest_pose = np.concatenate([rest_pose[..., :1], -rest_pose[..., 2:3],
                                    rest_pose[..., 1:2]], axis=-1)
        bones = np.concatenate([bones[..., :1], -bones[..., 2:3],
                                bones[..., 1:2]], axis=-1)
        rot_on_root = np.array([[1., 0., 0.], [0., 0., -1.], [0., 1., 0.]],
                               np.float32)
        root_rot = Rotation.from_rotvec(
            bones[..., 0, :].reshape(-1, 3)).as_matrix()
        bones[..., 0, :] = Rotation.from_matrix(
            rot_on_root[None] @ root_rot).as_rotvec().reshape(-1, 3)

    l2ws = np.array([get_smpl_l2ws_np(b, rest_pose=rest_pose) for b in bones])
    l2ws[..., :3, -1] += pelvis[:, None]
    kp3d = l2ws[..., :3, -1].copy().astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=ext_scale, skel=skel,
                                    extend_mm=250, head='-y').astype(
                                        np.float32)
    return kp3d, bones.astype(np.float32), skts, cyls, \
        rest_pose.astype(np.float32), pelvis.astype(np.float32)
