"""Foreground-mask tooling: dilation, packing, and (gated) segmentation
(torch port's copy of anerf_tpu/data/process_mask.py).

Re-design of reference core/process_mask.py + core/misc/save_mask_vid.py.
The reference runs a TF1 frozen-graph DeepLab-v3 person segmenter
(process_mask.py:83-129); that model format is deliberately not reproduced —
segmentation is pluggable: any callable image -> (H, W) person mask works
(e.g. a torchvision deeplabv3 when available). The surrounding machinery
(bbox-cropped inference, dilation, sampling-mask generation, h5 packing) is
implemented here with numpy/cv2.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np


def dilate_mask(mask: np.ndarray, iterations: int = 2) -> np.ndarray:
    """Binary dilation with a 3x3 cross, pure numpy (no cv2 dependency in
    the hot path)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        m = (m
             | np.roll(m, 1, 0) | np.roll(m, -1, 0)
             | np.roll(m, 1, 1) | np.roll(m, -1, 1))
    # roll wraps around; clear the borders it may have contaminated
    if iterations > 0:
        m[:iterations] &= mask[:iterations].astype(bool) | m[:iterations]
    return m.astype(mask.dtype)


def dilate_masks(masks: np.ndarray, iterations: int = 2) -> np.ndarray:
    """Batch dilation (N, H, W). Uses cv2's 5x5 kernel when available
    (matching the reference's dilation extent, load_surreal.py:50-59);
    falls back to the numpy cross dilation."""
    try:
        import cv2
        kernel = np.ones((5, 5), np.uint8)
        return np.stack([
            cv2.dilate(m.astype(np.uint8), kernel=kernel,
                       iterations=iterations) for m in masks])
    except ImportError:
        return np.stack([dilate_mask(m, iterations) for m in masks])


def make_sampling_masks(masks: np.ndarray, extend_iter: int = 2
                        ) -> np.ndarray:
    """Foreground masks -> dilated sampling masks (N, H, W, 1) uint8
    (reference load_surreal.py:215-221)."""
    m = masks[..., 0] if masks.ndim == 4 else masks
    out = dilate_masks(m.astype(np.uint8), extend_iter)
    return out[..., None].astype(np.uint8)


def make_bkgd_segmenter(bkgd: np.ndarray, thresh: float = 25.0,
                        blur: int = 3, min_component: int = 64
                        ) -> Callable:
    """Background-subtraction person segmenter — needs NO model weights.

    The datasets this tool targets ship (or median-extract) static
    background plates (reference load_h36m.py:17-112, load_zju.py
    per-pixel median, load_3dhp.py bkgd pngs), so |img - bkgd| plus
    morphology yields a usable person mask in environments where no
    pretrained segmenter can be downloaded. thresh is in 0-255 intensity
    units; min_component drops specks (connected components smaller than
    that many pixels) when cv2 is available.
    """
    bg = bkgd.astype(np.float32)

    def segment(img: np.ndarray) -> np.ndarray:
        diff = np.abs(img.astype(np.float32) - bg).max(-1)
        try:
            import cv2
            if blur > 1:
                diff = cv2.blur(diff, (blur, blur))
            m = (diff > thresh).astype(np.uint8)
            # close small holes, then drop small components
            kernel = np.ones((5, 5), np.uint8)
            m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel)
            n, labels, stats, _ = cv2.connectedComponentsWithStats(m)
            keep = np.zeros_like(m)
            for c in range(1, n):
                if stats[c, cv2.CC_STAT_AREA] >= min_component:
                    keep[labels == c] = 1
            return keep.astype(np.float32)
        except ImportError:
            return (diff > thresh).astype(np.float32)

    return segment


def make_torch_segmenter(model, person_class: int = 15) -> Callable:
    """Wrap a torchvision-style segmentation module into an
    image -> (H, W) float person-mask callable.

    `model` is any callable taking a (1, 3, H, W) ImageNet-normalized
    tensor and returning {'out': (1, C, H, W) logits} — the torchvision
    deeplabv3 contract (replacing the reference's TF1 frozen-graph
    DeepLabModel.run, core/process_mask.py:105-129). Kept injectable so
    the full inference+dilation+packing path is testable without
    downloading weights.
    """
    import torch
    mean = torch.tensor([0.485, 0.456, 0.406]).view(3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(3, 1, 1)

    def segment(img: np.ndarray) -> np.ndarray:
        x = torch.tensor(img.astype(np.float32) / 255.).permute(2, 0, 1)
        x = (x - mean) / std
        with torch.no_grad():
            out = model(x[None])['out'][0]
        # class 15 = person in COCO/VOC labeling
        return (out.argmax(0) == person_class).float().numpy()
    return segment


def get_segmenter(kind: str = 'auto', bkgd: Optional[np.ndarray] = None,
                  model=None, **kwargs) -> Optional[Callable]:
    """Return an image -> (H, W) float person-mask callable, or None.

    'bkgd': background-subtraction (make_bkgd_segmenter) — the only kind
    that works with zero downloads; requires a background plate.
    'torchvision': deeplabv3_resnet101 (requires torchvision; absent in
    minimal installs), or any injected `model` with the same contract.
    The reference's TF1 frozen graph is not supported.
    'auto': bkgd when a plate is given, else torchvision, else None.
    """
    if kind in ('auto', 'bkgd') and bkgd is not None:
        return make_bkgd_segmenter(bkgd, **kwargs)
    if kind == 'bkgd':
        raise ValueError("segmenter kind 'bkgd' requires a background "
                         "plate (bkgd=...)")
    if kind in ('auto', 'torchvision'):
        if model is not None:
            return make_torch_segmenter(model, **kwargs)
        try:
            import torchvision
            model = torchvision.models.segmentation.deeplabv3_resnet101(
                weights='DEFAULT').eval()
            return make_torch_segmenter(model, **kwargs)
        except ImportError:
            if kind == 'torchvision':
                raise
            return None
    raise NotImplementedError(kind)


def process_masks(imgs: Iterable[np.ndarray],
                  segment: Callable,
                  bboxes: Optional[np.ndarray] = None,
                  dilate_iter: int = 2):
    """Segment a sequence of images, optionally cropping to bboxes first
    (reference process_masks/process_bbox_masks, process_mask.py:131-226).

    bboxes: (N, 4) [x0, y0, x1, y1] or None for full-image inference.
    Returns (masks (N, H, W, 1) uint8, sampling_masks (N, H, W, 1) uint8).
    """
    masks = []
    for i, img in enumerate(imgs):
        H, W = img.shape[:2]
        if bboxes is not None:
            x0, y0, x1, y1 = [int(v) for v in bboxes[i]]
            crop = img[y0:y1, x0:x1]
            m = np.zeros((H, W), np.float32)
            if crop.size:
                m[y0:y1, x0:x1] = segment(crop)
        else:
            m = segment(img)
        masks.append((m > 0.5).astype(np.uint8))
    masks = np.stack(masks)
    sampling = dilate_masks(masks, dilate_iter)
    return masks[..., None], sampling[..., None]
