"""Batch assembly + background prefetching feeding the device (torch
port's copy of anerf_tpu/data/pipeline.py; numpy only).

Replaces the reference's DataLoader worker pool + pin_memory + collate
(core/load_data.py:78-80, core/dataset.py:748-820): a RayImageSampler-
equivalent permutation stream picks N_images per iteration, the batcher packs
fixed-shape numpy arrays in the train-step contract (index arrays int64,
the step's index dtype), and a small thread pool keeps a queue of ready
batches so host IO overlaps device compute. The train loop uploads each
batch in one copy (train/loop.py:upload_batch).

SUPER_BATCHES and ITEM_BATCHES count the batches assembled by the native
whole-dispatch path and by the per-item path; reset them to 0 to read the
batches of one run.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

SUPER_BATCHES = 0
ITEM_BATCHES = 0
_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


class ImagePermutationSampler:
    """Yields image indices such that every image is sampled once per epoch
    (reference RandIntGenerator + RayImageSampler, dataset.py:748-811)."""

    def __init__(self, n: int, n_images: int, seed: int = 0):
        self.n = n
        self.n_images = n_images
        self.rng = np.random.default_rng(seed)
        self._stream = iter(())

    def _refill(self):
        return iter(self.rng.permutation(self.n))

    def next_batch(self) -> np.ndarray:
        batch = []
        while len(batch) < self.n_images:
            try:
                batch.append(next(self._stream))
            except StopIteration:
                self._stream = self._refill()
        return np.sort(np.array(batch, dtype=np.int64))


def assemble_batch(dataset, img_idxs: np.ndarray) -> Dict[str, np.ndarray]:
    """Pack per-image samples into the flat train-step batch contract."""
    _count('ITEM_BATCHES')
    items = [dataset.get_item(int(i)) for i in img_idxs]
    n_images = len(items)
    n_per = items[0]['rays_o'].shape[0]

    def cat(key):
        return np.concatenate([it[key] for it in items], axis=0)

    rays_o = cat('rays_o')
    rays_d = cat('rays_d')
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    R = rays_o.shape[0]
    near = np.zeros((R, 1), np.float32)
    far = np.ones((R, 1), np.float32)
    rays = np.concatenate([rays_o, rays_d, near, far, viewdirs],
                          axis=-1).astype(np.float32)

    pose_idx = np.repeat(np.arange(n_images, dtype=np.int64), n_per)
    cam_idxs = np.repeat(
        np.array([it['cam_idxs'] for it in items], dtype=np.int64), n_per)

    batch = {
        'rays': rays,
        'target_s': cat('target_s').astype(np.float32),
        'fgs': cat('fgs').astype(np.float32),
        'bgs': (cat('bgs').astype(np.float32)
                if items[0]['bgs'] is not None else np.ones((R, 3),
                                                            np.float32)),
        'cam_idxs': cam_idxs,
        'pose_idx': pose_idx,
        'kp_idxs': np.array([it['kp_idx'] for it in items], dtype=np.int64),
        'kp3d': np.concatenate([it['kp3d'] for it in items]).astype(
            np.float32),
        'bones': np.concatenate([it['bones'] for it in items]).astype(
            np.float32),
        'skts': np.concatenate([it['skts'] for it in items]).astype(
            np.float32),
        'cyls': np.concatenate([it['cyls'] for it in items]).astype(
            np.float32),
    }
    if 'temp_val' in items[0]:
        batch['temp_val'] = np.array([it['temp_val'] for it in items],
                                     dtype=np.float32)
    if 'subject_idxs' in items[0]:
        batch['subject_idxs'] = np.array(
            [it['subject_idxs'] for it in items], dtype=np.int64)
    return batch


def assemble_super_batch(dataset, idx_lists, ops,
                         n_threads: int = 4) -> Dict[str, np.ndarray]:
    """Whole-dispatch batch assembly through the native library: ONE
    GIL-free multithreaded C++ call packs the ray/pixel blocks of all
    stack*n_images items straight into the stacked train-step layout
    (replacing per-item get_item + per-key concatenate/stack). Pose /
    camera metadata stays in numpy: bulk fancy-indexed gathers over the
    in-memory tables.

    Bit-compatible with the per-item native path: the per-item seed
    stream and the in-C++ sampling/gather logic are identical
    (tests/test_torch_data.py).
    """
    _count('SUPER_BATCHES')
    fs = dataset._native
    K, I = len(idx_lists), len(idx_lists[0])
    S = dataset.N_samples
    q_idxs = np.concatenate(idx_lists)
    M = K * I
    H, W = dataset.HW

    img_idxs = np.empty((M,), np.int64)
    dirs_idxs = np.empty((M,), np.int64)
    bg_rows = np.full((M,), -1, np.int64)
    c2ws = np.empty((M, 16), np.float32)
    focals = np.empty((M, 2), np.float32)
    cam_idxs = np.empty((M,), np.int64)
    kp_qidx = np.empty((M,), np.int64)
    kp_rows = np.empty((M,), np.int64)
    seeds = np.empty((M,), np.uint64)

    dirs_rows: List[np.ndarray] = []
    dirs_key_to_row: Dict = {}
    with dataset._rng_lock:
        for m in range(M):
            # one scalar draw per item, in item order — the exact stream
            # the per-item path consumes
            seeds[m] = dataset.rng.integers(0, 2 ** 63 - 1)
    for m in range(M):
        q = int(q_idxs[m])
        idx = dataset._idx_map[q] if dataset._idx_map is not None else q
        c2w, focal, center, cam_i = dataset.get_camera_data(
            idx, q, S)
        kp_real, kp_i = dataset.get_kp_idx(idx, q)
        img_idxs[m] = idx
        c2ws[m] = np.ascontiguousarray(c2w, np.float32).reshape(16)
        f = np.asarray(focal, np.float32).reshape(-1)
        focals[m, 0] = f[0]
        focals[m, 1] = f[1] if f.size > 1 else f[0]
        cam_idxs[m] = cam_i
        kp_qidx[m] = kp_i
        kp_rows[m] = kp_real
        if dataset.has_bg:
            bg_rows[m] = dataset.bg_idxs[idx]
        key = None if center is None else (float(center[0]),
                                           float(center[1]))
        row = dirs_key_to_row.get(key)
        if row is None:
            row = len(dirs_rows)
            dirs_key_to_row[key] = row
            dirs_rows.append(dataset._shifted_dirs(center))
        dirs_idxs[m] = row

    dirs = (dirs_rows[0][None] if len(dirs_rows) == 1
            else np.stack(dirs_rows))
    rays = np.empty((M * S, 11), np.float32)
    target = np.empty((M * S, 3), np.float32)
    fg = np.empty((M * S, 1), np.float32)
    bg = np.empty((M * S, 3), np.float32)
    fs.assemble_super_batch(
        ops['imgs'], ops['masks'], ops['smasks'], ops['bgs'],
        np.ascontiguousarray(dirs, np.float32),
        img_idxs, dirs_idxs, bg_rows, c2ws, focals, seeds,
        rays, target, fg, bg, S, H * W, int(dataset.mask_img), n_threads)

    R = I * S
    batch = {
        'rays': rays.reshape(K, R, 11),
        'target_s': target.reshape(K, R, 3),
        'fgs': fg.reshape(K, R, 1),
        'bgs': bg.reshape(K, R, 3),
        'cam_idxs': np.repeat(cam_idxs, S).reshape(K, R),
        'pose_idx': np.broadcast_to(
            np.repeat(np.arange(I, dtype=np.int64), S), (K, R)).copy(),
        'kp_idxs': kp_qidx.reshape(K, I),
        'kp3d': dataset.kp3d[kp_rows].astype(np.float32).reshape(
            K, I, *dataset.kp3d.shape[1:]),
        'bones': dataset.bones[kp_rows].astype(np.float32).reshape(
            K, I, *dataset.bones.shape[1:]),
        'skts': dataset.skts[kp_rows].astype(np.float32).reshape(
            K, I, *dataset.skts.shape[1:]),
        'cyls': dataset.cyls[kp_rows].astype(np.float32).reshape(
            K, I, *dataset.cyls.shape[1:]),
    }
    return batch


class BatchLoader:
    """Iterator of ready batches fed by a prefetching thread pool.

    Index batches are drawn from the sampler under a lock (global
    once-per-epoch coverage is preserved); workers assemble batches
    concurrently — h5 reads and the native sampling/gather extension release
    the GIL, so threads scale without worker processes (the reference uses
    16 DataLoader processes + pickling instead, core/load_data.py:78-80).
    """

    def __init__(self, dataset, n_images: int, prefetch: int = 6,
                 seed: int = 0, num_workers: int = 2,
                 stack: int = 1, stack_fn=None):
        self.dataset = dataset
        self.sampler = ImagePermutationSampler(len(dataset), n_images, seed)
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        # stack > 1: workers emit pre-stacked scan-unroll super-batches, so
        # the train loop's per-dispatch host work is just the device upload
        self.stack = max(1, stack)
        self.stack_fn = stack_fn
        # whole-dispatch C++ assembly (one GIL-free call per super-batch)
        # wherever the dataset offers it; the per-item path otherwise
        # (Concat/temporal wrappers, patch/NMS sampling, giant pixel
        # tables that shouldn't live in RAM)
        self._super_ops = (dataset.super_operands()
                           if hasattr(dataset, 'super_operands') else None)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sampler_lock = threading.Lock()

    def _make(self):
        with self._sampler_lock:
            # one lock hold for the whole super-batch keeps the sampler's
            # once-per-epoch coverage contiguous per dispatch
            idx_list = [self.sampler.next_batch() for _ in range(self.stack)]
        if self._super_ops is not None:
            batch = assemble_super_batch(self.dataset, idx_list,
                                         self._super_ops)
            if self.stack == 1:
                batch = {k: v[0] for k, v in batch.items()}
            return batch
        if self.stack == 1:
            return assemble_batch(self.dataset, idx_list[0])
        batches = [assemble_batch(self.dataset, i) for i in idx_list]
        return self.stack_fn(batches)

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def start(self):
        if not self._threads:
            for _ in range(self.num_workers):
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self.start()
        while True:
            yield self._q.get()

    def next(self) -> Dict[str, np.ndarray]:
        if not self._threads:
            return self._make()     # synchronous fallback
        return self._q.get()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
