"""Host-side h5 dataset: per-image pixel sampling -> fixed-shape ray batches
(torch port's copy of anerf_tpu/data/dataset.py; numpy only).

Re-design of reference core/dataset.py:20-542. The torch Dataset /
DataLoader / collate machinery is replaced by a plain class producing numpy
batches in the train step's contract (see train/trainer.py): per-ray
arrays of static shape (N_rand, ...) plus per-image pose tables
(N_images, ...) and a per-ray `pose_idx` slot map — the per-ray repeats the
reference materializes in collate (dataset.py:366-388, 813-820) happen as a
repeat inside the step instead. Index values are int64, the step's index
dtype; the JAX package emits the same values as int32.

`h5_path` is an h5 file's path or an in-memory `schema.H5Arrays` of the
same layout; h5py is imported only to open a path.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ops.cylinder import cylinder_to_box_2d
from ..ops.rays import nerf_c2w_to_extrinsic
from ..skeleton import SMPLSkeleton
from .schema import open_h5

# pixel tables larger than this stay in the h5 and go through the per-item
# path instead of the native whole-dispatch assembler
SUPER_CACHE_LIMIT_BYTES = 4 << 30


class BaseH5Dataset:
    """Pixel-sampled ray dataset over the canonical h5 schema.

    Subclasses define split/index maps + kp/cam index arithmetic by
    overriding `init_meta`, `get_kp_idx`, `get_cam_idx` (mirroring the
    reference subclass contract, dataset.py:391-405).
    """

    render_skip = 1
    N_render = 15

    def __init__(self, h5_path: str, N_samples: int = 96,
                 patch_size: int = 1, split: str = 'full',
                 N_nms: float = 0, subject: Optional[str] = None,
                 mask_img: bool = False, multiview: bool = False,
                 seed: Optional[int] = None, use_native: bool = True):
        self.h5_path = h5_path
        self.split = split
        self.dataset = None
        self.subject = subject
        self.mask_img = mask_img
        self.multiview = multiview

        self.N_samples = N_samples
        self.patch_size = patch_size
        self.N_nms = int(math.floor(N_nms)) if N_nms >= 1.0 else float(N_nms)
        self._idx_map = None
        self._render_idx_map = None
        self.rng = np.random.default_rng(seed)
        # the prefetch pool calls into the dataset from several threads;
        # numpy Generators are not thread-safe
        self._rng_lock = threading.Lock()

        # native C++ fast path for the sampling/gather inner loop
        # (anerf_torch/native); only covers the plain single-pixel sampler
        self._native = None
        if use_native and patch_size == 1 and N_nms == 0:
            from ..native import get_fast_sampler
            self._native = get_fast_sampler()

        self.init_meta()
        self.init_len()
        self.box2d = None
        if self.N_nms > 0.0:
            self.init_box2d()

    # ---- setup ----

    def init_len(self):
        if self._idx_map is not None:
            self.data_len = len(self._idx_map)
        else:
            with open_h5(self.h5_path) as f:
                self.data_len = len(f['imgs'])

    def init_dataset(self):
        if self.dataset is None:
            f = open_h5(self.h5_path)
            # cache Dataset handles: h5py's group[name] resolves the name
            # and constructs a fresh Dataset object per access
            self._h = {k: f[k]
                       for k in ('imgs', 'masks', 'sampling_masks')
                       if k in f}
            # publish the open-file flag LAST: concurrent BatchLoader
            # workers gate on `self.dataset is None` and then touch
            # self._h — the reverse order let a second worker race past
            # the guard before _h existed
            self.dataset = f

    def init_meta(self):
        """Load the small per-frame metadata into memory
        (reference dataset.py:125-182)."""
        with open_h5(self.h5_path) as f:
            self.dataset_keys = list(f.keys())
            self.has_bg = 'bkgds' in self.dataset_keys
            self.centers = f['centers'][:] if 'centers' in f else None

            img_shape = f['img_shape'][:]
            self._N_total_img = int(img_shape[0])
            self.HW = tuple(int(x) for x in img_shape[1:3])

            H, W = self.HW
            i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                               np.arange(H, dtype=np.float32), indexing='xy')
            i, j = i.reshape(-1), j.reshape(-1)
            if self.centers is None:
                offset_x, offset_y = W * 0.5, H * 0.5
            else:
                offset_x = offset_y = 0.0
            # precomputed pixel directions; first two cols divided by focal
            # at sample time
            self._dirs = np.stack([(i - offset_x), -(j - offset_y),
                                   -np.ones_like(i)], axis=-1)
            self._dirs_cache = {}
            self._pixel_idxs = np.arange(H * W).reshape(H, W)

            self.gt_kp3d = (f['gt_kp3d'][:] if 'gt_kp3d' in self.dataset_keys
                            else None)
            self.kp_map, self.kp_uidxs = None, None
            self.kp3d, self.bones, self.skts, self.cyls = \
                self._load_pose_data(f)
            self.focals, self.c2ws = self._load_camera_data(f)
            self.temp_validity = self.init_temporal_validity()

            if self.has_bg:
                self.bgs = f['bkgds'][:].reshape(-1, H * W, 3)
                self.bg_idxs = f['bkgd_idxs'][:].astype(np.int64)
            self.skel_type = SMPLSkeleton

    def _load_pose_data(self, f):
        kp3d, bones = f['kp3d'][:], f['bones'][:]
        skts, cyls = f['skts'][:], f['cyls'][:]
        if self.multiview:
            return self._load_multiview_pose(f, kp3d, bones, skts, cyls)
        return kp3d, bones, skts, cyls

    def _load_multiview_pose(self, f, kp3d, bones, skts, cyls):
        raise NotImplementedError

    def _load_camera_data(self, f):
        return f['focals'][:], f['c2ws'][:]

    def init_temporal_validity(self):
        return None

    def init_box2d(self):
        """Projected cylinder boxes per image for NMS sampling
        (dataset.py:207-233)."""
        H, W = self.HW
        box2d = []
        for idx in range(self._N_total_img):
            c2w, focal, center, _ = self.get_camera_data(idx, idx, 1)
            _, _, _, _, cyls = self.get_pose_data(idx, idx)
            tl, br, _ = cylinder_to_box_2d(
                cyls[0], [H, W, focal], nerf_c2w_to_extrinsic(c2w),
                center=center, scale=1.3)
            box2d.append((tl, br))
        self.box2d = np.array(box2d)

    def __len__(self):
        return self.data_len

    # ---- index arithmetic (subclass hooks) ----

    def get_kp_idx(self, idx, q_idx):
        # modulo keeps the base class valid for grid layouts where several
        # images share one pose row (1:1 datasets are unaffected: idx < len)
        return idx % len(self.kp3d), q_idx % len(self.kp3d)

    def get_cam_idx(self, idx, q_idx):
        return idx, q_idx

    # ---- per-image sampling ----

    def get_camera_data(self, idx, q_idx, N_samples):
        real_idx, cam_idx = self.get_cam_idx(idx, q_idx)
        focal = self.focals[real_idx]
        c2w = self.c2ws[real_idx].astype(np.float32)
        center = self.centers[real_idx] if self.centers is not None else None
        return c2w, focal, center, cam_idx

    def get_pose_data(self, idx, q_idx):
        """Single-row pose tables (no per-ray repeat — the repeat becomes a
        device-side gather via pose_idx)."""
        real_idx, kp_idx = self.get_kp_idx(idx, q_idx)
        kp = self.kp3d[real_idx:real_idx + 1].astype(np.float32)
        bone = self.bones[real_idx:real_idx + 1].astype(np.float32)
        cyl = self.cyls[real_idx:real_idx + 1].astype(np.float32)
        skt = self.skts[real_idx:real_idx + 1].astype(np.float32)
        return kp_idx, kp, bone, skt, cyl

    def sample_pixels(self, idx, q_idx):
        """Mask-restricted pixel sampling + optional patches + NMS box
        samples (dataset.py:277-344)."""
        p = self.patch_size
        N_rand = self.N_samples // int(p ** 2)
        sampling_mask = self._h['sampling_masks'][idx].reshape(-1)

        valid_idxs, = np.where(sampling_mask > 0)
        if len(valid_idxs) == 0:
            valid_idxs = np.arange(len(sampling_mask))
        replace = len(valid_idxs) < N_rand
        with self._rng_lock:
            sampled_idxs = self.rng.choice(valid_idxs, N_rand,
                                           replace=replace)

        if p > 1:
            H, W = self.HW
            hs, ws = sampled_idxs // W, sampled_idxs % W
            hs = np.clip(hs, 0, H - p)
            ws = np.clip(ws, 0, W - p)
            patches = [self._pixel_idxs[h:h + p, w:w + p].reshape(-1)
                       for h, w in zip(hs, ws)]
            sampled_idxs = np.array(patches).reshape(-1)

        if isinstance(self.N_nms, int):
            n_nms = self.N_nms
        else:
            n_nms = int(self.N_nms > self.rng.random())
        if n_nms > 0:
            nms_idxs = self._sample_in_box2d(idx, q_idx, sampling_mask, n_nms)
            sampled_idxs = np.sort(sampled_idxs)
            sampled_idxs[self.rng.choice(len(sampled_idxs), size=(n_nms,),
                                         replace=False)] = nms_idxs
        return np.sort(sampled_idxs)

    def _sample_in_box2d(self, idx, q_idx, fg, N_samples):
        H, W = self.HW
        real_idx, _ = self.get_cam_idx(idx, q_idx)
        tl, br = self.box2d[real_idx].copy()
        fg = fg.reshape(H, W)
        cropped = fg[tl[1]:br[1], tl[0]:br[0]]
        vy, vx = np.where(cropped < 1)
        vy, vx = vy + tl[1], vx + tl[0]
        idxs = vy * W + vx
        if len(idxs) == 0:
            idxs = np.arange(H * W)
        return self.rng.choice(idxs, size=(N_samples,),
                               replace=len(idxs) < N_samples)

    def get_rays(self, c2w, focal, pixel_idxs, center=None):
        """Per-pixel world rays from the precomputed direction mesh
        (dataset.py:346-364)."""
        dirs = self._dirs[pixel_idxs].copy()
        if center is not None:
            center = center.copy()
            center[1] *= -1
            dirs[..., :2] -= center
        if np.isscalar(focal) or np.asarray(focal).size == 1:
            dirs[:, :2] /= focal
        else:
            dirs[:, :2] /= np.asarray(focal).reshape(-1)[:2]

        if np.isclose(np.eye(3), c2w[:3, :3]).all():
            rays_d = dirs
        else:
            rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
        rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
        return rays_o.copy().astype(np.float32), rays_d.astype(np.float32)

    def get_img_data(self, idx, pixel_idxs):
        fg = self._h['masks'][idx, pixel_idxs].astype(np.float32)
        img = self._h['imgs'][idx, pixel_idxs].astype(np.float32) / 255.
        bg = None
        if self.has_bg:
            bg_idx = self.bg_idxs[idx]
            bg = self.bgs[bg_idx, pixel_idxs].astype(np.float32) / 255.
            if self.mask_img:
                img = img * fg + (1. - fg) * bg
        return img, fg, bg

    def _shifted_dirs(self, center):
        """Contiguous f32 direction mesh, optionally center-shifted; cached
        per distinct center (few cameras), not copied per item."""
        if center is None:
            key = None
        else:
            key = (float(center[0]), float(center[1]))
        cached = self._dirs_cache.get(key)
        if cached is None:
            dirs = np.ascontiguousarray(self._dirs, np.float32)
            if center is not None:
                dirs = dirs.copy()
                dirs[:, 0] -= np.float32(center[0])
                dirs[:, 1] -= np.float32(-center[1])
            self._dirs_cache[key] = cached = dirs
        return cached

    # in-RAM operand tables for the native whole-dispatch assembler; None
    # when the dataset shape is unsupported or the pixel data is too large
    _super_ops = None
    _super_tried = False

    def super_operands(self):
        """Operand tables for fast_sampler.assemble_super_batch: the pixel
        arrays loaded into RAM (u8), plus accessors the loader needs.
        Returns None when unsupported (no native extension, patch/NMS
        sampling, temporal wrapper) or when the pixel data exceeds
        SUPER_CACHE_LIMIT_BYTES (keeps the h5-streaming path for huge
        sets)."""
        if self._super_tried:
            return self._super_ops
        self._super_tried = True
        if self._native is None or self.temp_validity is not None:
            return None
        with open_h5(self.h5_path) as f:
            total = (f['imgs'].size + f['masks'].size
                     + f['sampling_masks'].size)
            if total > SUPER_CACHE_LIMIT_BYTES:
                return None
            H, W = self.HW
            self._super_ops = {
                'imgs': np.ascontiguousarray(f['imgs'][:]),
                'masks': np.ascontiguousarray(
                    f['masks'][:].reshape(-1, H * W)),
                'smasks': np.ascontiguousarray(
                    f['sampling_masks'][:].reshape(-1, H * W)),
                'bgs': (np.ascontiguousarray(self.bgs) if self.has_bg
                        else np.zeros((0, H * W, 3), np.uint8)),
            }
        return self._super_ops

    def _get_item_native(self, idx, c2w, focal, center):
        """C++ inner loop: sample + ray/pixel gathers in one pass.

        The operands cross into C++ as pointers to the numpy arrays;
        ctypes releases the interpreter lock for each call, so BatchLoader
        threads overlap."""
        fs = self._native
        h = self._h
        sampling_mask = np.ascontiguousarray(
            h['sampling_masks'][idx]).reshape(-1)
        with self._rng_lock:
            seed = int(self.rng.integers(0, 2 ** 63 - 1))
        pixel_idxs = fs.sample_mask_pixels(sampling_mask, self.N_samples,
                                           seed)

        dirs = self._shifted_dirs(center)
        f = np.asarray(focal, np.float32).reshape(-1)
        fx = float(f[0])
        fy = float(f[1]) if f.size > 1 else fx
        rays = fs.gather_rays(dirs, pixel_idxs,
                              np.ascontiguousarray(c2w, np.float32), fx, fy)
        rays_o, rays_d = rays[:, :3].copy(), rays[:, 3:].copy()

        img_row = np.ascontiguousarray(h['imgs'][idx])
        rgb = fs.gather_pixels(img_row, pixel_idxs, 3)
        mask_row = np.ascontiguousarray(h['masks'][idx])
        fg = mask_row[pixel_idxs].astype(np.float32)
        bg = None
        if self.has_bg:
            bg = self.bgs[self.bg_idxs[idx]][pixel_idxs].astype(
                np.float32) / 255.
            if self.mask_img:
                rgb = rgb * fg + (1. - fg) * bg
        return pixel_idxs, rays_o, rays_d, rgb, fg, bg

    def get_item(self, q_idx: int) -> Dict[str, np.ndarray]:
        """Rays/pixels for one image (reference __getitem__,
        dataset.py:57-105), without per-ray pose repeats."""
        idx = self._idx_map[q_idx] if self._idx_map is not None else q_idx
        self.init_dataset()

        c2w, focal, center, cam_idx = self.get_camera_data(
            idx, q_idx, self.N_samples)
        kp_idx, kp, bone, skt, cyl = self.get_pose_data(idx, q_idx)
        if self._native is not None:
            _, rays_o, rays_d, rays_rgb, fg, bg = self._get_item_native(
                idx, c2w, focal, center)
        else:
            pixel_idxs = self.sample_pixels(idx, q_idx)
            rays_o, rays_d = self.get_rays(c2w, focal, pixel_idxs, center)
            rays_rgb, fg, bg = self.get_img_data(idx, pixel_idxs)

        out = {
            'rays_o': rays_o, 'rays_d': rays_d, 'target_s': rays_rgb,
            'kp_idx': np.int64(kp_idx), 'kp3d': kp, 'bones': bone,
            'skts': skt, 'cyls': cyl, 'cam_idxs': np.int64(cam_idx),
            'fgs': fg[..., :1], 'bgs': bg,
        }
        if self.temp_validity is not None:
            # indexed by the image's place in the split, as kp_idx is:
            # the temporal loss reads the pose rows kp_idx -/+ 1. (The JAX
            # package indexes by the image; Mixamo's validity covers its
            # selection only, which that overruns.)
            nxt = (q_idx + 1) % len(self.temp_validity)
            out['temp_val'] = np.float32(
                (self.temp_validity[q_idx] + self.temp_validity[nxt]) // 2)
        return out

    # ---- meta / render contracts ----

    def _get_subset_idxs(self, render=False):
        if self._idx_map is not None:
            i_idxs = self._idx_map
            _k = _c = self._idx_map
            _kq = _cq = np.arange(len(self._idx_map))
        else:
            i_idxs = np.arange(self._N_total_img)
            _k = _kq = np.arange(len(self.kp3d))
            _c = _cq = np.arange(len(self.c2ws))
        k_idxs, kq_idxs = self.get_kp_idx(_k, _kq)
        c_idxs, cq_idxs = self.get_cam_idx(_c, _cq)
        return k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs

    def get_meta(self) -> Dict[str, Any]:
        """data_attrs contract (dataset.py:436-488)."""
        with open_h5(self.h5_path) as f:
            rest_pose = f['rest_pose'][:]
            betas = f['betas'][:]

        k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs = self._get_subset_idxs()
        H, W = self.HW
        if not np.isscalar(self.focals):
            H = np.repeat([H], len(c_idxs), 0)
            W = np.repeat([W], len(c_idxs), 0)
        hwf = (H, W, self.focals[c_idxs])

        center = self.centers[c_idxs].copy() if self.centers is not None \
            else None
        if len(betas) > 1:
            betas = betas[k_idxs]
        betas = betas.mean(0, keepdims=True).repeat(len(betas), 0)

        return {
            'hwf': hwf,
            'center': center,
            'c2ws': self.c2ws[c_idxs],
            'near': 60., 'far': 100.,  # placeholders; cylinder sets bounds
            'n_views': self.data_len,
            'skel_type': self.skel_type,
            'rest_pose': rest_pose,
            'gt_kp3d': (self.gt_kp3d[k_idxs] if self.gt_kp3d is not None
                        else None),
            'kp3d': self.kp3d[k_idxs],
            'skts': self.skts[k_idxs],
            'bones': self.bones[k_idxs],
            'betas': betas,
            'kp_map': self.kp_map,
            'kp_uidxs': self.kp_uidxs,
        }

    def get_render_data(self) -> Dict[str, Any]:
        """Held-out render/val contract (dataset.py:490-542)."""
        with open_h5(self.h5_path) as f:
            k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs = \
                self._get_subset_idxs(render=True)
            kq_idxs = kq_idxs[::self.render_skip][:self.N_render]
            cq_idxs = cq_idxs[::self.render_skip][:self.N_render]
            i_idxs = i_idxs[::self.render_skip][:self.N_render]
            k_idxs = k_idxs[::self.render_skip][:self.N_render]
            c_idxs = c_idxs[::self.render_skip][:self.N_render]

            H, W = self.HW
            imgs = f['imgs'][i_idxs].reshape(-1, H, W, 3).astype(
                np.float32) / 255.
            fgs = f['masks'][i_idxs].reshape(-1, H, W, 1)

        bgs = self.bgs.reshape(-1, H, W, 3).astype(np.float32) / 255. \
            if self.has_bg else None
        bg_idxs = self.bg_idxs[i_idxs] if self.has_bg else None

        Hs = np.repeat([H], len(c_idxs), 0)
        Ws = np.repeat([W], len(c_idxs), 0)
        center = self.centers[c_idxs].copy() if self.centers is not None \
            else None
        return {
            'imgs': imgs, 'fgs': fgs, 'bgs': bgs, 'bg_idxs': bg_idxs,
            'bg_idxs_len': len(self.bgs) if self.has_bg else 0,
            'cam_idxs': c_idxs, 'cam_idxs_len': len(self.c2ws),
            'c2ws': self.c2ws[c_idxs],
            'hwf': (Hs, Ws, self.focals[c_idxs]),
            'center': center,
            'kp_idxs': k_idxs, 'kp_idxs_len': len(self.kp3d),
            'kp3d': self.kp3d[k_idxs], 'skts': self.skts[k_idxs],
            'bones': self.bones[k_idxs],
        }


class PoseRefinedDataset(BaseH5Dataset):
    """Loads refined poses from a pose checkpoint instead of the h5
    (reference dataset.py:544-584). `refined_paths` maps subject ->
    (path, legacy_flag)."""

    refined_paths: Dict[str, Tuple[str, bool]] = {}

    def __init__(self, *args, load_refined: bool = False, **kwargs):
        self.load_refined = load_refined
        super().__init__(*args, **kwargs)

    def _load_pose_data(self, f):
        if not self.load_refined:
            return super()._load_pose_data(f)
        assert self.subject in self.refined_paths, \
            f'no refined pose path for {self.subject}'
        from ..pose.ckpt_compat import pose_ckpt_to_pose_data
        refined_path, legacy = self.refined_paths[self.subject]
        kp3d, bones, skts, cyls = pose_ckpt_to_pose_data(
            refined_path, legacy=legacy)[:4]
        if self.multiview:
            return self._load_multiview_pose(f, kp3d, bones, skts, cyls)
        return kp3d, bones, skts, cyls

    def get_render_data(self):
        render_data = super().get_render_data()
        k_idxs, c_idxs, i_idxs, kq_idxs, cq_idxs = \
            self._get_subset_idxs(render=True)
        kq_idxs = kq_idxs[::self.render_skip][:self.N_render]
        cq_idxs = cq_idxs[::self.render_skip][:self.N_render]
        render_data['kp_idxs'] = np.asarray(kq_idxs).copy()
        render_data['cam_idxs'] = np.asarray(cq_idxs).copy()
        return render_data


class ConcatH5Dataset:
    """Multi-subject concatenation with index offsets + subject codes
    (reference dataset.py:588-711)."""

    def __init__(self, datasets: List[BaseH5Dataset]):
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets])
        metas = [d.get_meta() for d in datasets]
        self.cumulative_views = np.cumsum([m['n_views'] for m in metas])
        self.cumulative_kps = np.cumsum([len(m['kp3d']) for m in metas])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def get_item(self, idx: int) -> Dict[str, np.ndarray]:
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, idx,
                                          side='right'))
        sample_idx = idx if dataset_idx == 0 else \
            idx - int(self.cumulative_sizes[dataset_idx - 1])
        ret = self.datasets[dataset_idx].get_item(sample_idx)
        if dataset_idx != 0:
            ret['cam_idxs'] = ret['cam_idxs'] + \
                int(self.cumulative_views[dataset_idx - 1])
            ret['kp_idx'] = ret['kp_idx'] + \
                int(self.cumulative_kps[dataset_idx - 1])
        ret['subject_idxs'] = np.int64(dataset_idx)
        return ret

    def get_meta(self):
        metas = [d.get_meta() for d in self.datasets]
        merged = {}
        H = np.concatenate([np.atleast_1d(m['hwf'][0]) for m in metas])
        W = np.concatenate([np.atleast_1d(m['hwf'][1]) for m in metas])
        focals = np.concatenate([np.atleast_1d(m['hwf'][2]) for m in metas])
        merged['hwf'] = (H, W, focals)
        merged['near'] = metas[0]['near']
        merged['far'] = metas[0]['far']
        merged['n_views'] = int(np.sum([m['n_views'] for m in metas]))
        merged['skel_type'] = metas[0]['skel_type']
        for k in ['rest_pose']:
            merged[k] = np.stack([m[k] for m in metas], axis=0)
        has_gt = all(m.get('gt_kp3d') is not None for m in metas)
        for k in ['gt_kp3d', 'kp3d', 'bones', 'betas']:
            if k == 'gt_kp3d' and not has_gt:
                continue
            try:
                merged[k] = np.concatenate([m[k] for m in metas])
            except ValueError:
                pass
        kp_lens = np.cumsum([len(m['kp3d']) for m in metas])
        merged['rest_pose_idxs'] = np.searchsorted(
            kp_lens, np.arange(len(merged['kp3d'])), side='right')
        merged['n_subjects'] = len(self.datasets)
        merged['kp_map'] = merged['kp_uidxs'] = None
        return merged

    def get_render_data(self):
        datas = [d.get_render_data() for d in self.datasets]
        # only render matching-shape subsets together (dataset.py:696-703)
        h0 = np.atleast_1d(datas[0]['hwf'][0])
        w0 = np.atleast_1d(datas[0]['hwf'][1])
        keep = [datas[0]]
        for r in datas[1:]:
            h = np.atleast_1d(r['hwf'][0])
            w = np.atleast_1d(r['hwf'][1])
            if h.flat[0] == h0.flat[0] and w.flat[0] == w0.flat[0]:
                keep.append(r)
        datas = keep
        merged = {}
        merged['hwf'] = tuple(
            np.concatenate([np.atleast_1d(r['hwf'][i]) for r in datas])
            for i in range(3))
        merged['center'] = None
        for k in ['imgs', 'fgs', 'bgs', 'c2ws', 'kp3d', 'skts', 'bones']:
            merged[k] = np.concatenate([r[k] for r in datas])
        for k in ['cam_idxs', 'kp_idxs', 'bg_idxs']:
            lens = np.cumsum([r[k + '_len'] for r in datas])
            arrays = [datas[0][k]]
            for i, r in enumerate(datas[1:]):
                arrays.append(r[k] + lens[i])
            merged[k] = np.concatenate(arrays)
        subject_idxs = []
        for i, r in enumerate(datas):
            subject_idxs.extend([i] * len(r['imgs']))
        merged['subject_idxs'] = np.array(subject_idxs)
        return merged
