"""The native batch assembler (C++, `fast_sampler.cpp`), built with g++
at first use into the git-ignored anerf_torch/_build/, keyed by the
source's hash as the kernels are, and bound with ctypes.

`get_fast_sampler()` returns the bound library or raises when it cannot
be built: the datasets take the numpy path only when the caller asks for
it (`use_native=False`), never because the build failed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name('fast_sampler.cpp')
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'

_lock = threading.Lock()
_cached: Optional['FastSampler'] = None


def build_fast_sampler() -> Path:
    """Compile fast_sampler.cpp into a shared library once per version of
    the source; returns its path. Raises when g++ is missing or fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f'fast_sampler_{digest}.so'
    if lib.exists():
        return lib
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('the native batch assembler needs g++ to build '
                           f'{SOURCE}; none is on PATH')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    cmd = [gxx, '-O3', '-shared', '-fPIC', '-std=c++17', '-pthread',
           '-Wall', '-Wextra', '-Werror', str(SOURCE), '-o', str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed for {SOURCE} ({proc.returncode}):\n'
                           f'{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib


def _ptr(a: np.ndarray, dtype, what: str) -> int:
    if a.dtype != dtype or not a.flags['C_CONTIGUOUS']:
        raise TypeError(f'{what} must be a C-contiguous {np.dtype(dtype)} '
                        f'array, got {a.dtype} contiguous='
                        f'{a.flags["C_CONTIGUOUS"]}')
    return a.ctypes.data


class FastSampler:
    """The library's four functions on numpy arrays. Each checks dtypes,
    contiguity and sizes before it passes pointers; ctypes releases the
    interpreter lock for the call, so the loader's threads overlap."""

    def __init__(self, path: Path):
        self.path = path
        lib = ctypes.CDLL(str(path))
        p, i64, u64, d, i = (ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_uint64, ctypes.c_double, ctypes.c_int)
        lib.anerf_sample_mask_pixels.argtypes = [p, i64, i64, u64, p]
        lib.anerf_gather_rays.argtypes = [p, p, i64, p, d, d, p]
        lib.anerf_gather_pixels.argtypes = [p, p, i64, i64, p]
        lib.anerf_assemble_super_batch.argtypes = \
            [p] * 11 + [i64] + [p] * 4 + [i64, i64, i, i]
        for fn in (lib.anerf_sample_mask_pixels, lib.anerf_gather_rays,
                   lib.anerf_gather_pixels, lib.anerf_assemble_super_batch):
            fn.restype = i
        self._lib = lib

    def sample_mask_pixels(self, mask: np.ndarray, n_samples: int,
                           seed: int) -> np.ndarray:
        """(n_samples,) int64 sorted pixel indices where mask > 0."""
        out = np.empty((n_samples,), np.int64)
        self._lib.anerf_sample_mask_pixels(
            _ptr(mask, np.uint8, 'mask'), mask.size, n_samples, seed,
            out.ctypes.data)
        return out

    def gather_rays(self, dirs: np.ndarray, idxs: np.ndarray,
                    c2w: np.ndarray, focal_x: float, focal_y: float
                    ) -> np.ndarray:
        """(S, 6) float32 [o d] of the pixels `idxs` of the (HW, 3)
        direction mesh."""
        if dirs.ndim != 2 or dirs.shape[1] != 3 or c2w.size != 16 \
                or (idxs.size and not 0 <= idxs.min() <= idxs.max()
                    < dirs.shape[0]):
            raise ValueError('gather_rays: bad operand shapes or indices')
        out = np.empty((idxs.size, 6), np.float32)
        self._lib.anerf_gather_rays(
            _ptr(dirs, np.float32, 'dirs'), _ptr(idxs, np.int64, 'idxs'),
            idxs.size, _ptr(c2w, np.float32, 'c2w'), focal_x, focal_y,
            out.ctypes.data)
        return out

    def gather_pixels(self, img_row: np.ndarray, idxs: np.ndarray,
                      channels: int) -> np.ndarray:
        """(S, channels) float32 of the u8 pixels `idxs`, over 255."""
        if img_row.size % channels or (
                idxs.size and not 0 <= idxs.min() <= idxs.max()
                < img_row.size // channels):
            raise ValueError('gather_pixels: bad operand shapes or indices')
        out = np.empty((idxs.size, channels), np.float32)
        self._lib.anerf_gather_pixels(
            _ptr(img_row, np.uint8, 'img_row'), _ptr(idxs, np.int64, 'idxs'),
            idxs.size, channels, out.ctypes.data)
        return out

    def assemble_super_batch(self, imgs, masks, smasks, bgs, dirs, img_idxs,
                             dirs_idxs, bg_rows, c2ws, focals, seeds, rays,
                             target, fg, bg, S: int, HW: int, mask_img: int,
                             n_threads: int) -> None:
        """Fill rays / target / fg / bg (see fast_sampler.cpp) for the
        M = len(img_idxs) items."""
        M = img_idxs.size
        n_img = imgs.shape[0]
        if not (imgs.shape[1:] == (HW, 3) and masks.shape == (n_img, HW)
                and smasks.shape == (n_img, HW)
                and dirs.shape[1:] == (HW, 3)
                and bgs.shape[1:] == (HW, 3)
                and dirs_idxs.size == bg_rows.size == seeds.size == M
                and c2ws.shape == (M, 16) and focals.shape == (M, 2)
                and rays.shape == (M * S, 11) and target.shape == (M * S, 3)
                and fg.shape == (M * S, 1) and bg.shape == (M * S, 3)):
            raise ValueError('assemble_super_batch: operand shapes do not '
                             'match')
        if M and not (0 <= img_idxs.min() and img_idxs.max() < n_img
                      and 0 <= dirs_idxs.min()
                      and dirs_idxs.max() < dirs.shape[0]
                      and bg_rows.max() < bgs.shape[0]):
            raise ValueError('assemble_super_batch: an index is out of '
                             'range')
        u8, f32, i64 = np.uint8, np.float32, np.int64
        self._lib.anerf_assemble_super_batch(
            _ptr(imgs, u8, 'imgs'), _ptr(masks, u8, 'masks'),
            _ptr(smasks, u8, 'smasks'), _ptr(bgs, u8, 'bgs'),
            _ptr(dirs, f32, 'dirs'), _ptr(img_idxs, i64, 'img_idxs'),
            _ptr(dirs_idxs, i64, 'dirs_idxs'), _ptr(bg_rows, i64, 'bg_rows'),
            _ptr(c2ws, f32, 'c2ws'), _ptr(focals, f32, 'focals'),
            _ptr(seeds, np.uint64, 'seeds'), M, _ptr(rays, f32, 'rays'),
            _ptr(target, f32, 'target'), _ptr(fg, f32, 'fg'),
            _ptr(bg, f32, 'bg'), S, HW, mask_img, n_threads)


def get_fast_sampler() -> FastSampler:
    """The bound native library, built on first use (once per process)."""
    global _cached
    with _lock:
        if _cached is None:
            _cached = FastSampler(build_fast_sampler())
        return _cached
