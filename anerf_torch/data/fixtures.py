"""Synthetic dataset fixtures in the canonical h5 schema (torch port's
copy of anerf_tpu/data/fixtures.py; numpy only, array for array the same
dataset).

Generates a SURREAL-like dataset: random SMPL poses on a camera ring,
images rendered by splatting Gaussian blobs at projected joints. Gives tests
and the chip smoke test a learnable end-to-end signal without any external
data. `synthetic_data` returns the arrays; `make_synthetic_h5` also writes
them (h5py); `fixture_source` gives a tool's fixture as that file where
h5py is installed, as the arrays where it is not.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.cylinder import get_kp_bounding_cylinder
from ..ops.fk import get_smpl_l2ws_np
from ..ops.rays import nerf_c2w_to_extrinsic, world_to_cam_np
from ..skeleton import SMPLSkeleton, smpl_rest_pose
from .schema import write_h5


def _look_at_c2w(cam_pos, target, up=(0.0, 1.0, 0.0)):
    """NeRF-convention c2w: columns [right, up, -forward], -z looks at
    target."""
    cam_pos = np.asarray(cam_pos, np.float32)
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = cam_pos
    return c2w


def _bkgd_texture(H: int, W: int) -> np.ndarray:
    """Deterministic non-constant background plate (sinusoid grid)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r = 0.55 + 0.25 * np.sin(xx * 0.21) * np.cos(yy * 0.17)
    g = 0.55 + 0.25 * np.sin((xx + yy) * 0.13)
    b = 0.55 + 0.25 * np.cos(xx * 0.09 - yy * 0.19)
    return np.clip(np.stack([r, g, b], -1), 0, 1)


def _render_limbs(kp2d: np.ndarray, xx: np.ndarray, yy: np.ndarray,
                  H: int, W: int, width: float = 1.8):
    """Capsule limbs between parent/child joint projections, per-limb
    color gradients, textured background — thin structures for culling/
    quality stress tests."""
    img = _bkgd_texture(H, W).copy()
    mask = np.zeros((H, W), np.uint8)
    jt = SMPLSkeleton.joint_trees
    for j in range(1, len(jt)):
        p0 = kp2d[jt[j]].astype(np.float32)
        p1 = kp2d[j].astype(np.float32)
        seg = p1 - p0
        L2 = float(seg @ seg) + 1e-8
        # point-to-segment distance per pixel
        t = np.clip(((xx - p0[0]) * seg[0] + (yy - p0[1]) * seg[1]) / L2,
                    0.0, 1.0)
        dx = xx - (p0[0] + t * seg[0])
        dy = yy - (p0[1] + t * seg[1])
        d = np.sqrt(dx * dx + dy * dy)
        inside = d < width
        cap_a = np.array([0.15 + 0.85 * (j % 3 == 0),
                          0.15 + 0.85 * (j % 3 == 1),
                          0.15 + 0.85 * (j % 3 == 2)], np.float32)
        cap_b = np.array([0.9 - 0.6 * (j % 2), 0.4 + 0.5 * (j % 2), 0.7],
                         np.float32)
        color = cap_a[None, None] * (1 - t[..., None]) \
            + cap_b[None, None] * t[..., None]
        img = np.where(inside[..., None], color, img)
        mask |= inside
    return img, mask


def _bkgd_texture_fine(H: int, W: int) -> np.ndarray:
    """High-frequency background plate (period ~4 px at 96x96)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r = 0.5 + 0.3 * np.sin(xx * 1.6) * np.cos(yy * 1.4)
    g = 0.5 + 0.3 * np.sign(np.sin((xx + yy) * 0.9)) * 0.8
    b = 0.5 + 0.3 * np.cos(xx * 1.1 - yy * 1.3)
    return np.clip(np.stack([r, g, b], -1), 0, 1)


def _render_clutter(kp3d: np.ndarray, clutter3d: np.ndarray,
                    ext: np.ndarray, xx: np.ndarray, yy: np.ndarray,
                    H: int, W: int, focal: float,
                    limb_width: float, clutter_px: float):
    """Third adversarial fixture family: striped capsule
    limbs (high-frequency texture ON the body), rigid OFF-BODY clutter
    spheres inside the cutoff windows but away from the skeleton, and a
    high-frequency background. Elements are painted far-to-near by
    camera depth, so self-occlusion boundaries exist.

    kp3d (J, 3) world joints; clutter3d (C, 3) world sphere centers.
    """
    img = _bkgd_texture_fine(H, W).copy()
    mask = np.zeros((H, W), np.uint8)
    jt = SMPLSkeleton.joint_trees

    def cam_depth(p):
        return float(-(ext[:3, :3] @ p + ext[:3, 3])[2])

    def project(p):
        c = ext[:3, :3] @ p + ext[:3, 3]
        return np.array([W * 0.5 + focal * c[0] / -c[2],
                         H * 0.5 - focal * c[1] / -c[2]], np.float32)

    elems = []
    for j in range(1, len(jt)):
        mid = 0.5 * (kp3d[jt[j]] + kp3d[j])
        elems.append((cam_depth(mid), 'limb', j))
    for c in range(len(clutter3d)):
        elems.append((cam_depth(clutter3d[c]), 'clutter', c))
    elems.sort(key=lambda e: -e[0])   # far first

    for depth, kind, idx in elems:
        if kind == 'limb':
            j = idx
            p0 = project(kp3d[jt[j]])
            p1 = project(kp3d[j])
            seg = p1 - p0
            L2 = float(seg @ seg) + 1e-8
            t = np.clip(((xx - p0[0]) * seg[0] + (yy - p0[1]) * seg[1]) / L2,
                        0.0, 1.0)
            dx = xx - (p0[0] + t * seg[0])
            dy = yy - (p0[1] + t * seg[1])
            inside = (dx * dx + dy * dy) < limb_width ** 2
            # hard stripes along the limb axis, period ~4 px
            period = max(4.0, 0.08 * np.sqrt(L2))
            band = (np.sin(t * np.sqrt(L2) * (2 * np.pi / period))
                    > 0.0).astype(np.float32)[..., None]
            ca = np.array([0.95 * (j % 3 == 0) + 0.05,
                           0.95 * (j % 3 == 1) + 0.05,
                           0.95 * (j % 3 == 2) + 0.05], np.float32)
            cb = np.array([0.9, 0.9, 0.1], np.float32) if j % 2 else \
                np.array([0.1, 0.85, 0.9], np.float32)
            color = ca[None, None] * band + cb[None, None] * (1.0 - band)
        else:
            p = project(clutter3d[idx])
            d2 = (xx - p[0]) ** 2 + (yy - p[1]) ** 2
            inside = d2 < clutter_px ** 2
            checker = (((xx // 2).astype(int) + (yy // 2).astype(int)) % 2
                       ).astype(np.float32)[..., None]
            ca = np.array([1.0, 0.3, 0.0], np.float32) if idx % 2 else \
                np.array([0.0, 0.4, 1.0], np.float32)
            color = ca[None, None] * checker + (1.0 - checker) * 0.95
        img = np.where(inside[..., None], color, img)
        mask |= inside
    return img, mask


def make_synthetic_h5(path: str, n_kps: int = 8, n_cams: int = 3,
                      H: int = 64, W: int = 64, seed: int = 0,
                      ext_scale: float = 0.3,
                      style: str = 'blobs') -> dict:
    """Write synthetic_data(...) to `path` in the h5 schema; returns the
    data dict."""
    data = synthetic_data(n_kps=n_kps, n_cams=n_cams, H=H, W=W, seed=seed,
                          ext_scale=ext_scale, style=style)
    write_h5(path, data)
    return data


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def fixture_source(d: str, n_kps: int = 8, n_cams: int = 3, H: int = 64,
                   style: str = 'blobs'):
    """The square synthetic fixture of directory `d`, made there if
    needed: the path of its h5 file (written once), or where h5py is
    absent its arrays in memory (an H5Arrays naming the path its file
    would have)."""
    from .schema import h5_arrays

    h5 = os.path.join(d, 'syn_train_h5py.h5')
    os.makedirs(d, exist_ok=True)
    if not have_h5py():
        return h5_arrays(synthetic_data(n_kps=n_kps, n_cams=n_cams, H=H,
                                        W=H, style=style), path=h5)
    if not os.path.exists(h5):
        make_synthetic_h5(h5, n_kps=n_kps, n_cams=n_cams, H=H, W=H,
                          style=style)
    return h5


def synthetic_data(n_kps: int = 8, n_cams: int = 3, H: int = 64,
                   W: int = 64, seed: int = 0, ext_scale: float = 0.3,
                   style: str = 'blobs') -> dict:
    """A synthetic dataset dict (SURREAL grid layout: N_cams x N_kps).

    ext_scale=0.3 puts the body at ~1 unit tall, filling a good fraction of
    the frame from the ~2.5-unit camera ring.

    style:
      'blobs' — gaussian blobs at the 2D joint projections (fast, easy).
      'limbs' — capsule limbs between parent/child joints with per-limb
        color gradients on a textured (non-constant) background — a
        harder scene with thin structures, for stressing sample-culling
        and quality protocols.
      'clutter' — third adversarial family: striped
        limbs (high-frequency on-body texture), rigid off-body clutter
        spheres inside the cutoff windows but off the skeleton, hard
        self-occlusion (depth-ordered painting), high-frequency
        background."""
    rng = np.random.default_rng(seed)
    rest = (smpl_rest_pose * ext_scale).astype(np.float32)

    bones = (rng.normal(size=(n_kps, 24, 3)) * 0.15).astype(np.float32)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest_pose=rest) for b in bones])
    kp3d = l2ws[..., :3, 3].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    # fixture world is y-up (smpl rest pose head at +y)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=0.001, head='y')

    # off-body clutter: spheres rigidly attached to joint local frames at
    # offsets well inside the cutoff windows (0.5 units at the default
    # cutoff_mm=500 / ext_scale=1e-3 recipe) but off the skeleton — content
    # a sample-culling policy must not starve of trained samples
    clutter_joints = np.array([4, 5, 18, 19, 12, 0])
    clutter_local = (rng.normal(size=(len(clutter_joints), 3))
                     * 0.12).astype(np.float32)
    clutter_local += np.sign(clutter_local) * 0.18   # push 0.18-0.4 off-joint
    clutter3d = np.einsum(
        'kjab,jb->kja',
        l2ws[:, clutter_joints, :3, :3], clutter_local) \
        + kp3d[:, clutter_joints]                     # (n_kps, C, 3)

    focal = 1.2 * W
    radius = 2.5
    c2ws, imgs, masks = [], [], []
    center_of_mass = kp3d.mean(axis=(0, 1))
    for c in range(n_cams):
        angle = 2 * np.pi * c / n_cams
        cam_pos = center_of_mass + radius * np.array(
            [np.sin(angle), 0.1, np.cos(angle)], np.float32)
        c2w = _look_at_c2w(cam_pos, center_of_mass)
        ext = nerf_c2w_to_extrinsic(c2w)
        for k in range(n_kps):
            kp2d = world_to_cam_np(kp3d[k], ext, H, W, focal)
            mask = np.zeros((H, W), np.uint8)
            yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
            if style == 'limbs':
                img, mask = _render_limbs(kp2d, xx, yy, H, W)
            elif style == 'clutter':
                img, mask = _render_clutter(
                    kp3d[k], clutter3d[k], ext, xx, yy, H, W, focal,
                    limb_width=1.8 * W / 64.0, clutter_px=3.0 * W / 64.0)
            else:
                img = np.zeros((H, W, 3), np.float32)
                for j, (x, y) in enumerate(kp2d):
                    d2 = (xx - x) ** 2 + (yy - y) ** 2
                    blob = np.exp(-d2 / (2 * 2.5 ** 2))
                    color = np.array([0.2 + 0.8 * (j % 3 == 0),
                                      0.2 + 0.8 * (j % 3 == 1),
                                      0.2 + 0.8 * (j % 3 == 2)], np.float32)
                    img += blob[..., None] * color
                    mask |= (d2 < 6.0 ** 2)
                img = np.clip(img, 0, 1)
                # white background outside the blobs
                img = img + (1.0 - np.clip(img.sum(-1, keepdims=True),
                                           0, 1))
            imgs.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
            masks.append(mask)
        c2ws.append(c2w)

    # camera grid: (n_cams,) expanded per image
    c2ws = np.repeat(np.stack(c2ws), n_kps, axis=0).astype(np.float32)
    imgs = np.stack(imgs)
    masks = np.stack(masks)[..., None]
    # dilate sampling mask by a few pixels
    samp = masks.copy()[..., 0]
    for _ in range(2):
        samp = (samp
                | np.roll(samp, 1, 0) | np.roll(samp, -1, 0)
                | np.roll(samp, 1, 1) | np.roll(samp, -1, 1))
    sampling_masks = samp[..., None].astype(np.uint8)

    n_imgs = n_cams * n_kps
    data = {
        'imgs': imgs,
        'masks': masks.astype(np.uint8),
        'sampling_masks': sampling_masks,
        'bkgds': ((_bkgd_texture(H, W)[None] if style == 'limbs'
                   else _bkgd_texture_fine(H, W)[None] if style == 'clutter'
                   else np.ones((1, H, W, 3))) * 255).astype(np.uint8),
        'bkgd_idxs': np.zeros((n_imgs,), np.int64),
        'kp3d': np.tile(kp3d, (1, 1, 1)),
        'gt_kp3d': kp3d,
        'bones': bones,
        'skts': skts,
        'cyls': cyls,
        'rest_pose': rest,
        'betas': np.zeros((1, 10), np.float32),
        'c2ws': c2ws,
        'focals': np.full((n_imgs,), focal, np.float32),
        'ext_scale': float(ext_scale),
    }
    return data


# ------------------------------------------- the other dataset types' layouts

H36M_CAMERAS = ('54138969', '55011271', '58860488', '60457274')
_SHARED = ('rest_pose', 'betas', 'ext_scale')


def _grid(base, n_kps, n_cams, H, W, seed):
    """The synthetic (n_cams, n_kps) grid to rearrange: `base` as given,
    else synthetic_data at these sizes."""
    if base is None:
        base = synthetic_data(n_kps=n_kps, n_cams=n_cams, H=H, W=W,
                              seed=seed)
    n = len(base['kp3d'])
    if len(base['imgs']) < n_cams * n or n < n_kps:
        raise ValueError(f'the base grid has {len(base["imgs"]) // n} '
                         f'cameras x {n} poses; {n_cams} x {n_kps} needed')
    return base


def _pick(base, cams, poses, pose_rows=None):
    """Images (cams[i], poses[i]) of the grid, in that order, with their
    cameras; the pose tables at `pose_rows` (default: one row per image,
    its pose)."""
    n = len(base['kp3d'])
    img = np.asarray(cams) * n + np.asarray(poses)
    rows = np.asarray(poses if pose_rows is None else pose_rows)
    out = {k: base[k][img] for k in ('imgs', 'masks', 'sampling_masks',
                                     'c2ws', 'focals')}
    out.update({k: base[k][rows] for k in ('kp3d', 'bones', 'skts',
                                            'cyls')})
    out.update({k: base[k] for k in _SHARED})
    return out


def h36m_data(n_instants: int = 2, H: int = 64, W: int = 64, seed: int = 0,
              subject: str = 'S9',
              seqs=('Directions-1', 'Walking-1'), base=None) -> dict:
    """A Human3.6M layout (data/process_h36m.py): sequence-named
    img_paths (<subject>/<Seq>/imageSequence/<cam>/img_%06d.jpg), 4
    cameras in camera-major order within a sequence, one pose row per
    image with the 4 views of an instant sharing the body pose, 8
    background plates (4 clean, 4 chair; bkgd_idxs the camera).
    len(seqs) x 4 x n_instants images."""
    n_seq = len(seqs)
    base = _grid(base, n_seq * n_instants, 4, H, W, seed)
    cams, poses, paths = [], [], []
    for s, seq in enumerate(seqs):
        for c, cam in enumerate(H36M_CAMERAS):
            for k in range(n_instants):
                cams.append(c)
                poses.append(s * n_instants + k)
                paths.append(f'{subject}/{seq}/imageSequence/{cam}/'
                             f'img_{k:06d}.jpg')
    data = _pick(base, cams, poses)
    data['img_paths'] = np.array(paths)
    data['bkgds'] = np.repeat(base['bkgds'][:1], 2 * len(H36M_CAMERAS), 0)
    data['bkgd_idxs'] = np.array(cams, np.int64)
    return data


def perfcap_data(n_frames: int = 8, H: int = 64, W: int = 64, seed: int = 0,
                 base=None) -> dict:
    """A MonoPerfCap layout (data/process_perfcap.py): one camera, one
    pose row a frame, one background plate."""
    base = _grid(base, n_frames, 1, H, W, seed)
    data = _pick(base, [0] * n_frames, np.arange(n_frames))
    data.update(kp_idxs=np.arange(n_frames), cam_idxs=np.arange(n_frames),
                bkgds=base['bkgds'][:1],
                bkgd_idxs=np.zeros((n_frames,), np.int64))
    return data


def mixamo_data(n_frames: int = 3, n_cams: int = 2, H: int = 64,
                W: int = 64, seed: int = 0, subject: str = 'James',
                seqs=('Jab', 'Kick'), base=None):
    """A Mixamo layout (data/process_mixamo.py) and its selection:
    img_paths <subject>/<seq>/Camera_<c>/ImageNNNN.png (sequence, camera,
    frame order), one pose row an image, kp_idxs the sequence-offset
    frame, cam_idxs the camera, white-composited images. Returns (data,
    selected): `selected` drops every 8th image, so the subset has
    temporal gaps; save it as data/mixamo.selected_path(h5 path)."""
    n_seq = len(seqs)
    base = _grid(base, n_seq * n_frames, n_cams, H, W, seed)
    cams, poses, paths = [], [], []
    for s, seq in enumerate(seqs):
        for c in range(n_cams):
            for fr in range(n_frames):
                cams.append(c)
                poses.append(s * n_frames + fr)
                paths.append(f'{subject}/{seq}/Camera_{c}/'
                             f'Image{fr + 1:04d}.png')
    data = _pick(base, cams, poses)
    m = data['masks'].astype(np.uint8)
    data['imgs'] = (data['imgs'] * m + (1 - m) * 255).astype(np.uint8)
    data.update(img_paths=np.array(paths), kp_idxs=np.array(poses),
                cam_idxs=np.array(cams))
    n = len(paths)
    selected = np.array([i for i in range(n) if i % 8 != 7], np.int64)
    return data, selected


def zju_data(n_frames: int = 2, n_cams: int = 3, H: int = 64, W: int = 64,
             seed: int = 0, base=None) -> dict:
    """A ZJU-MoCap layout (data/process_zju.py): frame-major images (the
    cameras of a frame together), kp_idxs the frame, img_pose_indices the
    camera; per-camera c2ws, focals (n_cams, 2), centers (n_cams, 2) and
    background plates (bkgd_idxs the camera); one pose row a frame."""
    base = _grid(base, n_frames, n_cams, H, W, seed)
    frames = np.repeat(np.arange(n_frames), n_cams)
    cams = np.tile(np.arange(n_cams), n_frames)
    data = _pick(base, cams, frames, pose_rows=np.arange(n_frames))
    n = len(base['kp3d'])
    first = np.arange(n_cams) * n            # one image of each camera
    f = base['focals'][first]
    data.update(
        c2ws=base['c2ws'][first],
        focals=np.stack([f, f], -1).astype(np.float32),
        centers=np.tile(np.array([[W * 0.5, H * 0.5]], np.float32),
                        (n_cams, 1)),
        kp_idxs=frames, img_pose_indices=cams,
        bkgds=np.repeat(base['bkgds'][:1], n_cams, 0),
        bkgd_idxs=cams.astype(np.int64))
    return data


def mpi3dhp_data(n_frames: int = 9, H: int = 64, W: int = 64, seed: int = 0,
                 base=None) -> dict:
    """An MPI-INF-3DHP layout (data/process_3dhp.py): one camera, one pose
    row a frame, gt_kp3d, one background plate."""
    data = perfcap_data(n_frames=n_frames, H=H, W=W, seed=seed, base=base)
    data['gt_kp3d'] = data['kp3d'].copy()
    return data
