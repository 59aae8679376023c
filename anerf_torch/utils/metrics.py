"""Evaluation metrics: PSNR, SSIM, MPJPE / PA-MPJPE (torch port's copy of
anerf_tpu/utils/metrics.py; numpy only).

Mirrors the protocol of reference core/utils/evaluation_helpers.py:257-612:
full-image, foreground-masked, and valid-box PSNR/SSIM variants, plus
Procrustes-aligned joint error.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def psnr(img: np.ndarray, target: np.ndarray,
         mask: Optional[np.ndarray] = None) -> float:
    img = np.asarray(img, np.float64)
    target = np.asarray(target, np.float64)
    se = (img - target) ** 2
    if mask is not None:
        mask = np.asarray(mask)
        if mask.ndim == se.ndim - 1:
            mask = mask[..., None]
        m = np.broadcast_to(mask.astype(bool), se.shape)
        if m.sum() == 0:
            return float('nan')
        mse = se[m].mean()
    else:
        mse = se.mean()
    if mse <= 1e-12:
        return float('inf')
    return float(-10.0 * np.log10(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along H and W of (H, W, C)."""
    from numpy.lib.stride_tricks import sliding_window_view
    win = len(k)
    v = sliding_window_view(img, win, axis=0)
    v = np.tensordot(v, k, axes=([-1], [0]))
    v = sliding_window_view(v, win, axis=1)
    return np.tensordot(v, k, axes=([-1], [0]))


def _filter2d_same(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Zero-padded 'same' separable convolution (the conv math of the
    reference's pinned pytorch-msssim fork: F.conv2d with
    padding=window_size//2, groups=channel). Zero padding commutes with
    the separable decomposition, so this equals the full 2D conv."""
    pad = len(k) // 2
    img = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    return _filter2d_sep(img, k)


def ssim(img: np.ndarray, target: np.ndarray,
         mask: Optional[np.ndarray] = None,
         data_range: float = 1.0) -> float:
    """Single-scale SSIM with an 11x1.5 gaussian window.

    Matches the conv math of pytorch-msssim (the reference's SSIM backend,
    run_render.py:17): zero-padded same-size convolution, so the SSIM map
    covers the full image incl. borders. mask (H, W) reproduces the
    reference's fg_ssim: (map * mask).sum() / (mask.sum() * C)
    (reference run_render.py:953-958).
    """
    img = np.asarray(img, np.float64)
    target = np.asarray(target, np.float64)
    if img.ndim == 2:
        img = img[..., None]
        target = target[..., None]
    k = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_x = _filter2d_same(img, k)
    mu_y = _filter2d_same(target, k)
    sigma_x = _filter2d_same(img * img, k) - mu_x ** 2
    sigma_y = _filter2d_same(target * target, k) - mu_y ** 2
    sigma_xy = _filter2d_same(img * target, k) - mu_x * mu_y

    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2))
    if mask is not None:
        m = np.asarray(mask, np.float64)
        denom = m.sum() * ssim_map.shape[-1]
        if denom == 0:
            return float('nan')
        return float((ssim_map * m[..., None]).sum() / denom)
    return float(ssim_map.mean())


def evaluate_metric_arrays(rgbs: np.ndarray, gts: np.ndarray,
                           fgs: Optional[np.ndarray] = None,
                           boxes: Optional[np.ndarray] = None
                           ) -> Dict[str, float]:
    """Full + fg-masked + valid-box PSNR/SSIM over an image stack.

    rgbs/gts: (N, H, W, 3) in [0, 1]; fgs: (N, H, W, 1);
    boxes: (N, 2, 2) [(tl), (br)] pixel boxes.
    """
    out: Dict[str, list] = {'psnr': [], 'ssim': []}
    if fgs is not None:
        out['fg_psnr'] = []
        out['fg_ssim'] = []
    if boxes is not None:
        out['box_psnr'] = []
        out['box_ssim'] = []
    for i in range(len(rgbs)):
        out['psnr'].append(psnr(rgbs[i], gts[i]))
        out['ssim'].append(ssim(rgbs[i], gts[i]))
        if fgs is not None:
            m = fgs[i][..., 0] > 0
            out['fg_psnr'].append(psnr(rgbs[i], gts[i], m))
            out['fg_ssim'].append(ssim(rgbs[i], gts[i], m))
        if boxes is not None:
            (x0, y0), (x1, y1) = boxes[i]
            out['box_psnr'].append(psnr(rgbs[i][y0:y1, x0:x1],
                                        gts[i][y0:y1, x0:x1]))
            out['box_ssim'].append(ssim(rgbs[i][y0:y1, x0:x1],
                                        gts[i][y0:y1, x0:x1]))
    return {k: float(np.nanmean(v)) for k, v in out.items()}


def procrustes(X: np.ndarray, Y: np.ndarray
               ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Similarity-transform alignment of Y onto X (per-frame least squares).

    X, Y: (J, 3). Returns (Z, tform) where Z is the aligned Y.
    Mirrors the protocol of evaluation_helpers.py:387-467.
    """
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    ssX = (X0 ** 2).sum()
    ssY = (Y0 ** 2).sum()
    normX, normY = np.sqrt(ssX), np.sqrt(ssY)
    X0 /= normX
    Y0 /= normY
    U, s, Vt = np.linalg.svd(X0.T @ Y0)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V[:, -1] *= -1
        s[-1] *= -1
        R = V @ U.T
    scale = s.sum() * normX / normY
    t = muX - scale * muY @ R
    Z = scale * Y @ R + t
    return Z, {'rotation': R, 'scale': scale, 'translation': t}


def mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean per-joint position error, (N, J, 3) arrays."""
    return float(np.linalg.norm(pred - gt, axis=-1).mean())


def pa_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Procrustes-aligned MPJPE (per-frame alignment)."""
    errs = []
    for p, g in zip(pred, gt):
        z, _ = procrustes(g, p)
        errs.append(np.linalg.norm(z - g, axis=-1).mean())
    return float(np.mean(errs))
