"""Software turntable renderer for extracted meshes (torch port's numpy
copy of anerf_tpu/utils/mesh_render.py).

Replaces the reference's EGL/OpenGL offscreen pipeline: normal-as-color
shading, turntable at fixed degree steps, image stack / jpg output.
Implementation is a vectorized numpy z-buffered surface splatter: each
face is sampled at a density matched to its screen footprint and samples
are depth-tested per pixel. For marching-cubes/tetrahedra meshes (faces
at voxel scale) this is visually equivalent to rasterization and has no
GL/EGL dependency.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .marching import compute_vertex_normals


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)


def normalize_mesh(verts: np.ndarray) -> np.ndarray:
    """Center at origin, scale longest axis to ~1."""
    center = 0.5 * (verts.max(0) + verts.min(0))
    v = verts - center
    scale = np.abs(v).max()
    return v / max(scale, 1e-9)


def _sample_faces(verts, normals, faces, samples_per_edge: int):
    """Barycentric sample grid over every face: (S, 3) points + normals."""
    n = samples_per_edge
    us, vs = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing='ij')
    keep = (us + vs) <= 1.0 + 1e-9
    u, v = us[keep], vs[keep]
    w = 1.0 - u - v
    bary = np.stack([w, u, v], -1).astype(np.float32)       # (B, 3)

    tri = verts[faces]                                       # (F, 3, 3)
    tri_n = normals[faces]                                   # (F, 3, 3)
    pts = np.einsum('bk,fkc->fbc', bary, tri).reshape(-1, 3)
    nrm = np.einsum('bk,fkc->fbc', bary, tri_n).reshape(-1, 3)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-9)
    return pts, nrm


def render_mesh_image(verts: np.ndarray, faces: np.ndarray,
                      rot: Optional[np.ndarray] = None,
                      res: int = 512, zoom: float = 0.85,
                      samples_per_edge: Optional[int] = None,
                      bg: float = 1.0) -> np.ndarray:
    """One orthographic normal-shaded view. Returns (res, res, 3) float.

    samples_per_edge defaults to the screen-space size of the largest face
    (hole-free coverage at any face/voxel scale)."""
    if len(faces) == 0:
        return np.full((res, res, 3), bg, np.float32)
    normals = compute_vertex_normals(verts, faces)
    if samples_per_edge is None:
        tri = verts[faces]
        edge = np.linalg.norm(
            tri - tri[:, [1, 2, 0]], axis=-1).max()
        px = edge * 0.5 * zoom * (res - 1)   # [-1,1] -> pixels
        samples_per_edge = int(np.clip(np.ceil(px) + 1, 2, 24))
    pts, nrm = _sample_faces(verts, normals, faces, samples_per_edge)
    if rot is not None:
        pts = pts @ rot.T
        nrm = nrm @ rot.T

    # orthographic projection: x right, y up (flip image rows), z depth
    xy = pts[:, :2] * zoom
    px = ((xy[:, 0] * 0.5 + 0.5) * (res - 1)).round().astype(np.int64)
    py = ((-xy[:, 1] * 0.5 + 0.5) * (res - 1)).round().astype(np.int64)
    ok = (px >= 0) & (px < res) & (py >= 0) & (py < res)
    px, py = px[ok], py[ok]
    depth = pts[ok, 2]
    color = nrm[ok] * 0.5 + 0.5      # normal-as-color (color.fs shading)

    idx = py * res + px
    # z-buffer: keep the max-depth (closest to viewer at +z) per pixel
    order = np.argsort(depth)        # ascending; later writes win
    idx, color = idx[order], color[order]
    img = np.full((res * res, 3), bg, np.float32)
    img[idx] = color
    return img.reshape(res, res, 3)


def overlay_mesh_on_image(verts: np.ndarray, faces: np.ndarray,
                          img: np.ndarray, extrinsic: np.ndarray,
                          focal, center=None, alpha: float = 0.65,
                          samples_per_edge: Optional[int] = None
                          ) -> np.ndarray:
    """Normal-shaded mesh composited over a camera image — the debug
    overlay equivalent of the reference's pyrender SMPL renderer, driven
    by the extracted density mesh instead of an SMPL body model.

    img: (H, W, 3) float in [0, 1]; extrinsic: CV world-to-camera 4x4
    (ops/rays.py:nerf_c2w_to_extrinsic); focal: scalar or (fx, fy).
    Returns the composited (H, W, 3) image (alpha-blended where the mesh
    projects, untouched elsewhere).
    """
    out = np.asarray(img, np.float32).copy()
    if len(faces) == 0:
        return out
    H, W = out.shape[:2]
    f = np.asarray(focal, np.float32).reshape(-1)
    fx = float(f[0])
    fy = float(f[1]) if f.size > 1 else fx
    ox, oy = ((W * 0.5, H * 0.5) if center is None
              else (float(center[0]), float(center[1])))

    normals = compute_vertex_normals(verts, faces)
    if samples_per_edge is None:
        # screen-space footprint of the largest edge sets the density
        vh = np.concatenate([verts, np.ones_like(verts[..., :1])], -1)
        cam_v = vh @ extrinsic.T
        z_v = np.maximum(cam_v[:, 2], 1e-6)
        pix_v = np.stack([cam_v[:, 0] / z_v * fx, cam_v[:, 1] / z_v * fy],
                         -1)
        tri = pix_v[faces]
        edge = np.linalg.norm(tri - tri[:, [1, 2, 0]], axis=-1).max()
        samples_per_edge = int(np.clip(np.ceil(edge) + 1, 2, 24))

    pts, nrm = _sample_faces(verts, normals, faces, samples_per_edge)
    pts_h = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    cam = pts_h @ extrinsic.T
    z = cam[:, 2]
    ok = z > 1e-6
    cam, nrm, z = cam[ok], nrm[ok], z[ok]
    px = (cam[:, 0] / z * fx + ox).round().astype(np.int64)
    py = (cam[:, 1] / z * fy + oy).round().astype(np.int64)
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    px, py, z, nrm = px[ok], py[ok], z[ok], nrm[ok]
    if px.size == 0:
        return out

    color = nrm * 0.5 + 0.5
    idx = py * W + px
    # z-buffer: smallest camera depth wins (sort far-to-near; later
    # writes overwrite)
    order = np.argsort(-z)
    idx, color = idx[order], color[order]
    shade = np.full((H * W, 3), np.nan, np.float32)
    shade[idx] = color
    covered = np.isfinite(shade[..., 0])
    flat = out.reshape(-1, 3)
    flat[covered] = (alpha * shade[covered]
                     + (1.0 - alpha) * flat[covered])
    return flat.reshape(H, W, 3)


def render_turntable(verts: np.ndarray, faces: np.ndarray,
                     step_deg: float = 4.0, res: int = 512,
                     normalize: bool = True) -> np.ndarray:
    """360-degree turntable. Returns (n_views, res, res, 3)."""
    if normalize:
        verts = normalize_mesh(verts)
    frames = []
    for deg in np.arange(0.0, 360.0, step_deg):
        rot = _rot_y(np.radians(deg))
        frames.append(render_mesh_image(verts, faces, rot, res=res))
    return np.stack(frames)
