"""Minimal SMPL joint model as vendorable tables — no smplx, no mesh
(torch port's copy of anerf_tpu/data/smpl_tables.py).

Everything this framework needs from the SMPL body model is linear maps
through the mesh, so the mesh never has to exist at runtime:

* zero-pose joints are exactly linear in the shape coefficients:
      J(betas) = J_regressor @ (v_template + shapedirs @ betas)
               = j_template + j_shapedirs @ betas
  with j_template = J_regressor @ v_template            (24, 3)
  and  j_shapedirs[j, :, b] = J_regressor @ shapedirs[..., b]  (24, 3, 10).
  This replaces the smplx SMPL forward in the betas->rest-pose paths
  (process_spin.rest_pose_from_betas, process_zju.get_smpls; reference
  core/process_spin.py:110-127, core/load_zju.py get_smpls).

* any linear joint regressor applied to LBS-posed vertices collapses to
  per-(regressed-joint, skin-joint) tables. With skinning weights W
  (V, J), regressor Jr (K, V) and rest vertices v(betas, pose) =
  v_template + shapedirs @ betas + posedirs @ f(pose):
      h_k = sum_j [ R_j @ (a_kj(betas, pose) - s_kj * jrest_j)
                    + s_kj * g_j ]
  where s_kj = sum_i Jr_ki W_ij (scalars, (K, J)),
        a_kj = sum_i Jr_ki W_ij v_i  ->  reg_template (K, J, 3)
               + reg_shapedirs (K, J, 3, 10) @ betas
               + reg_posedirs (K, J, 3, 207) @ (R[1:] - I).flatten,
  and (R_j, g_j) are the global joint rotations/positions from FK —
  exactly smplx's lbs() output for the regressed joints, without the
  (V, 3) mesh. This replaces SMPLEvalHelper + vertices2joints in the
  SMPL-regressed H36M evaluation (reference
  core/utils/evaluation_helpers.py:525-612).

The tables derive from the official SMPL release (SMPL_NEUTRAL.pkl +
smpl/data/J_regressor_h36m.npy), whose license forbids redistribution —
so this repo ships the MATH and the one-time converter
(`make_tables_from_smpl_pkl`), not the numbers. Build the npz once where
the official files live and point ANERF_SMPL_TABLES (or the `path`
argument) at it; see tools/real_data_runbook.md.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

ENV_VAR = 'ANERF_SMPL_TABLES'

#: SPIN's H36M-convention regressed-joint reindexing
#: (reference evaluation_helpers.py:538)
SPIN_TO_CANON = [10, 8, 14, 15, 16, 11, 12, 13, 4, 5, 6, 1, 2, 3, 0, 7, 9]

_REQUIRED = ('j_template', 'j_shapedirs')
_EVAL_KEYS = ('reg_weights', 'reg_template', 'reg_shapedirs')


class SMPLTablesMissing(ImportError):
    """Raised when neither smplx nor a tables npz is available."""


def load_tables(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Load the tables npz. Resolution order: explicit path,
    $ANERF_SMPL_TABLES.

    Raises SMPLTablesMissing with build instructions when absent.
    """
    path = path or os.environ.get(ENV_VAR)
    if not path or not os.path.exists(path):
        raise SMPLTablesMissing(
            'SMPL joint tables not found. Build them once from the '
            'official SMPL_NEUTRAL.pkl with '
            'anerf_torch.data.smpl_tables.make_tables_from_smpl_pkl and set '
            f'{ENV_VAR}=<tables.npz> (see tools/real_data_runbook.md). '
            f'(searched: {path!r})')
    with np.load(path) as z:
        tables = {k: z[k].astype(np.float64) for k in z.files}
    for k in _REQUIRED:
        if k not in tables:
            raise ValueError(f'tables npz {path} missing {k}')
    return tables


def joints_from_betas(betas: np.ndarray,
                      tables: Dict[str, np.ndarray]) -> np.ndarray:
    """Zero-pose SMPL joints for shape coefficients.

    betas (N, B) -> (N, J, 3); exactly J_regressor @ shaped template
    (what smplx's SMPL forward returns for identity pose through the
    24-joint mapper, reference process_spin.py:12).
    """
    betas = np.asarray(betas, np.float64)
    if betas.ndim == 1:
        betas = betas[None]
    B = betas.shape[-1]
    return (tables['j_template'][None]
            + np.einsum('jcb,nb->njc', tables['j_shapedirs'][..., :B],
                        betas)).astype(np.float64)


def _pose_feature(rots: np.ndarray) -> np.ndarray:
    """smplx lbs() pose blendshape features: (R[1:] - I) flattened.

    rots (N, J, 3, 3) -> (N, (J-1)*9).
    """
    eye = np.eye(3)
    return (rots[:, 1:] - eye).reshape(rots.shape[0], -1)


def regress_joints(betas: np.ndarray, rots: np.ndarray,
                   tables: Dict[str, np.ndarray],
                   transl: Optional[np.ndarray] = None) -> np.ndarray:
    """Regressed joints of the POSED SMPL body, mesh-free.

    betas (N, B), rots (N, J, 3, 3) full-pose rotation matrices
    (global_orient at index 0, pose2rot=False semantics). Returns
    (N, K, 3) in SMPL's canonical frame — numerically identical to
    J_regressor_extra @ LBS vertices (reference SMPLEvalHelper.forward)
    up to f64 rounding.
    """
    from ..ops.fk import get_smpl_l2ws_np

    for k in _EVAL_KEYS:
        if k not in tables:
            raise ValueError(f'tables npz lacks eval key {k} — rebuild '
                             'with a joint regressor (see '
                             'make_tables_from_smpl_pkl(regressor=...))')
    betas = np.asarray(betas, np.float64)
    rots = np.asarray(rots, np.float64)
    N, J = rots.shape[:2]
    B = betas.shape[-1]

    jrest = joints_from_betas(betas, tables)                   # (N, J, 3)
    # a_kj(betas, pose): regressor-weighted rest vertices per skin joint
    a = (tables['reg_template'][None]
         + np.einsum('kjcb,nb->nkjc', tables['reg_shapedirs'][..., :B],
                     betas))                                   # (N, K, J, 3)
    if 'reg_posedirs' in tables:
        a = a + np.einsum('kjcp,np->nkjc', tables['reg_posedirs'],
                          _pose_feature(rots))
    s = tables['reg_weights']                                  # (K, J)

    # FK: global rotations + joint positions per frame (root at origin)
    out = np.zeros((N, s.shape[0], 3))
    for n in range(N):
        l2w = get_smpl_l2ws_np(rots[n], rest_pose=jrest[n].astype(
            np.float32), use_rot_mats=True).astype(np.float64)
        Rg, g = l2w[:, :3, :3], l2w[:, :3, 3]                  # (J,3,3),(J,3)
        local = a[n] - s[..., None] * jrest[n][None]           # (K, J, 3)
        out[n] = (np.einsum('jab,kjb->ka', Rg, local)
                  + s @ g)
    if transl is not None:
        out = out + np.asarray(transl, np.float64)[:, None]
    return out


def make_tables_from_smpl_pkl(smpl_pkl: str, out_npz: str,
                              regressor_npy: Optional[str] = None) -> str:
    """One-time conversion: official SMPL pkl (+ optional extra joint
    regressor, e.g. smpl/data/J_regressor_h36m.npy) -> tables npz.

    Reads only plain arrays from the pkl (J_regressor may be scipy
    sparse). The official SMPL_NEUTRAL.pkl pickles chumpy arrays for some
    fields; if unpickling fails, convert it first with the standard
    smplx tool (`python -m smplx.tools.clean_ch`) or np.asarray each
    field in an environment that has chumpy — the MATH here needs only
    the dense values.
    """
    import pickle

    with open(smpl_pkl, 'rb') as f:
        model = pickle.load(f, encoding='latin1')

    def dense(x):
        if hasattr(x, 'toarray'):
            return np.asarray(x.toarray(), np.float64)
        return np.asarray(x, np.float64)

    Jr = dense(model['J_regressor'])           # (J, V)
    v_template = dense(model['v_template'])    # (V, 3)
    shapedirs = dense(model['shapedirs'])      # (V, 3, B)
    tables = {
        'j_template': Jr @ v_template,
        'j_shapedirs': np.einsum('jv,vcb->jcb', Jr, shapedirs),
    }
    if regressor_npy is not None:
        Jx = np.load(regressor_npy).astype(np.float64)   # (K, V)
        W = dense(model['weights'])                      # (V, J)
        tables['reg_weights'] = np.einsum('kv,vj->kj', Jx, W)
        tables['reg_template'] = np.einsum('kv,vj,vc->kjc', Jx, W,
                                           v_template)
        tables['reg_shapedirs'] = np.einsum('kv,vj,vcb->kjcb', Jx, W,
                                            shapedirs)
        if 'posedirs' in model:
            pd = dense(model['posedirs'])                # (V, 3, P)
            tables['reg_posedirs'] = np.einsum('kv,vj,vcp->kjcp', Jx, W,
                                               pd)
    np.savez_compressed(out_npz, **tables)
    return out_npz
