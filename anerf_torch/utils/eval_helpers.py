"""Evaluation utilities: metric logs, event read-back, video tooling
(torch port's copy of anerf_tpu/utils/eval_helpers.py; numpy only).

Completes the reference evaluation-helper surface
(core/utils/evaluation_helpers.py): psnr/ssim txt appenders, tfevent scalar
readers for post-hoc analysis, video concatenation, and the full
evaluate-and-dump flow over rendered stacks. Numeric metrics live in
utils/metrics.py.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .metrics import mpjpe, pa_mpjpe


def write_metric_txts(outdir: str, metrics_per_image: Dict[str, List[float]]
                      ) -> None:
    """Append psnr.txt / ssim.txt style logs (evaluation_helpers.py:356-383).
    One line per image, final line is the mean."""
    os.makedirs(outdir, exist_ok=True)
    for name, vals in metrics_per_image.items():
        with open(os.path.join(outdir, f'{name}.txt'), 'a') as f:
            for i, v in enumerate(vals):
                f.write(f'{i} {v}\n')
            f.write(f'mean {np.nanmean(vals)}\n')


def evaluate_metric(rgbs: np.ndarray, gts: np.ndarray,
                    fgs: Optional[np.ndarray] = None,
                    boxes: Optional[np.ndarray] = None,
                    outdir: Optional[str] = None,
                    render_factor: int = 0) -> Dict[str, float]:
    """Full evaluation flow over a rendered stack: PSNR/SSIM (+fg, +box
    variants), optional txt dumps (evaluation_helpers.py:257-385)."""
    if render_factor > 0:
        try:
            import cv2
            H, W = rgbs.shape[1:3]
            gts = np.stack([cv2.resize(g, (W, H)) for g in gts])
            if fgs is not None:
                fgs = np.stack([cv2.resize(
                    f.astype(np.float32), (W, H))[..., None] for f in fgs])
        except ImportError:
            pass
    from .metrics import psnr, ssim
    per_image: Dict[str, List[float]] = {'psnr': [], 'ssim': []}
    for i in range(len(rgbs)):
        per_image['psnr'].append(psnr(rgbs[i], gts[i]))
        per_image['ssim'].append(ssim(rgbs[i], gts[i]))
        if fgs is not None:
            m = fgs[i][..., 0] > 0
            per_image.setdefault('fg_psnr', []).append(
                psnr(rgbs[i], gts[i], m))
            per_image.setdefault('fg_ssim', []).append(
                ssim(rgbs[i], gts[i], m))
        if boxes is not None:
            (x0, y0), (x1, y1) = boxes[i]
            per_image.setdefault('box_psnr', []).append(
                psnr(rgbs[i][y0:y1, x0:x1], gts[i][y0:y1, x0:x1]))
            per_image.setdefault('box_ssim', []).append(
                ssim(rgbs[i][y0:y1, x0:x1], gts[i][y0:y1, x0:x1]))
    if outdir is not None:
        write_metric_txts(outdir, per_image)
    return {k: float(np.nanmean(v)) for k, v in per_image.items()}


def evaluate_pose_error(pred_kp3d: np.ndarray, gt_kp3d: np.ndarray,
                        ext_scale: float = 0.001) -> Dict[str, float]:
    """MPJPE / PA-MPJPE in millimeters (evaluation_helpers.py:469-612)."""
    scale = 1.0 / ext_scale
    return {
        'mpjpe_mm': mpjpe(pred_kp3d, gt_kp3d) * scale,
        'pa_mpjpe_mm': pa_mpjpe(pred_kp3d, gt_kp3d) * scale,
    }


def evaluate_pampjpe_from_smpl_params(gt_kps: np.ndarray, betas: np.ndarray,
                                      bones: np.ndarray,
                                      tables=None,
                                      ret_kp: bool = False):
    """PA-MPJPE / MPJPE of SMPL-regressed H36M joints vs mm-scale GT.

    Mirrors the reference evaluate_pampjpe_from_smpl_params
    (core/utils/evaluation_helpers.py:541-612): pose the SMPL body with the
    (refined) bone rotations, regress the 17 H36M joints, reindex with
    SPIN_TO_CANON, Procrustes-align per frame for PA-MPJPE, and center both
    at canonical joint 14 (the H36M pelvis) for translation-free MPJPE.
    GT is millimeters (H36M convention), predictions are meters; both
    returned metrics are in mm. Mesh-free: the regression runs through the
    precomputed linear tables of data/smpl_tables.py instead of smplx,
    so no (V, 3) vertex buffer or SMPL pkl is needed at eval time.

    bones: (N, 24, 3) axis-angle. betas: (1 or N, 10). tables: preloaded
    table dict, else loaded from $ANERF_SMPL_TABLES.
    """
    from scipy.spatial.transform import Rotation

    from ..data.smpl_tables import (SPIN_TO_CANON, load_tables,
                                    regress_joints)
    from .metrics import procrustes

    if tables is None:
        tables = load_tables()
    gt_kps = np.asarray(gt_kps, np.float64)
    betas = np.asarray(betas, np.float64)
    bones = np.asarray(bones, np.float64)
    if betas.ndim == 1:
        betas = betas[None]
    if betas.shape[0] == 1:
        betas = np.repeat(betas, len(gt_kps), 0)
    rots = Rotation.from_rotvec(bones.reshape(-1, 3)).as_matrix().reshape(
        *bones.shape[:2], 3, 3)

    pred_kps = regress_joints(betas, rots, tables)[:, SPIN_TO_CANON]

    # PA-MPJPE: per-frame similarity alignment of pred onto the mm-scale GT
    # (scale is part of the alignment, so the mm units come from GT)
    pa_errs = []
    for p, g in zip(pred_kps, gt_kps):
        z, _ = procrustes(g, p)
        pa_errs.append(np.linalg.norm(z - g, axis=-1).mean())
    pampjpe = float(np.mean(pa_errs))

    # MPJPE: center both at canonical joint 14, GT mm -> m, report mm
    pred_c = pred_kps - pred_kps[:, 14:15]
    gt_c = (gt_kps - gt_kps[:, 14:15]) / 1000.0
    mpjpe_mm = float(np.linalg.norm(pred_c - gt_c, axis=-1).mean() * 1000.0)

    if ret_kp:
        return pampjpe, mpjpe_mm, pred_kps
    return pampjpe, mpjpe_mm


def read_tfevent_scalars(logdir: str,
                         tags: Optional[Sequence[str]] = None
                         ) -> Dict[str, List]:
    """Read scalar curves back from TB event files
    (evaluation_helpers.py:28-67)."""
    from tensorboard.backend.event_processing import event_accumulator
    ea = event_accumulator.EventAccumulator(
        logdir, size_guidance={event_accumulator.SCALARS: 0})
    ea.Reload()
    available = ea.Tags().get('scalars', [])
    tags = tags if tags is not None else available
    out = {}
    for tag in tags:
        if tag in available:
            out[tag] = [(e.step, e.value) for e in ea.Scalars(tag)]
    return out


def read_metrics_jsonl(path: str) -> List[Dict]:
    """Read the framework's JSONL metric stream."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def concat_videos(paths: Sequence[str], out_path: str, axis: int = 1,
                  fps: int = 14) -> None:
    """Concatenate mp4s side-by-side (evaluation_helpers.py:140, without the
    ffmpeg CLI dependency)."""
    import imageio.v2 as imageio
    readers = [imageio.mimread(p, memtest=False) for p in paths]
    n = min(len(r) for r in readers)
    frames = [np.concatenate([r[i] for r in readers], axis=axis)
              for i in range(n)]
    imageio.mimwrite(out_path, frames, fps=fps)
