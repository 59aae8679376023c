"""Iso-surface extraction (marching tetrahedra) + PLY export (torch
port's numpy copy of anerf_tpu/utils/marching.py).

Replaces the reference's PyMCubes + trimesh dependency: a self-contained
numpy marching-tetrahedra over the density grid produced by
render/raycaster.py:render_mesh_density. Each cube splits into 6
tetrahedra; each tet contributes 0/1/2 triangles with vertices interpolated
on crossing edges. Topologically watertight, no case tables.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# 6 tetrahedra per cube, by cube-corner index (corners in binary xyz order:
# 0=(0,0,0), 1=(1,0,0), 2=(0,1,0), 3=(1,1,0), 4=(0,0,1), ...)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 7, 5],
    [0, 5, 7, 4],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
], dtype=np.int64)

_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64)


def marching_tetrahedra(volume: np.ndarray, level: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface `volume == level`.

    volume: (X, Y, Z) scalar field. Returns (verts (V, 3) in voxel
    coordinates, faces (F, 3) int).
    """
    vol = np.asarray(volume, np.float32)
    nx, ny, nz = vol.shape

    # cube base coordinates
    bx, by, bz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing='ij')
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)  # (C, 3)

    # only keep cubes the surface crosses
    corner_vals = np.stack(
        [vol[base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz]
         for dx, dy, dz in _CORNER_OFFSETS], -1)  # (C, 8)
    inside = corner_vals > level
    crossing = inside.any(-1) & ~inside.all(-1)
    base = base[crossing]
    corner_vals = corner_vals[crossing]
    if len(base) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    corner_pos = base[:, None, :] + _CORNER_OFFSETS[None]  # (C, 8, 3)

    tri_list = []
    for tet in _TETS:
        v = corner_vals[:, tet]          # (C, 4)
        p = corner_pos[:, tet]           # (C, 4, 3)
        ins = v > level                  # (C, 4)
        n_in = ins.sum(-1)

        def interp(pa, pb, va, vb):
            t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12,
                                        vb - va)
            t = np.clip(t, 0.0, 1.0)[..., None]
            return pa + t * (pb - pa)

        # one-inside (or one-outside): single triangle
        for target, flip in ((1, False), (3, True)):
            sel = (n_in == target)
            if not sel.any():
                continue
            vv, pp, ii = v[sel], p[sel], ins[sel]
            if flip:
                ii = ~ii
            apex = np.argmax(ii, -1)
            others = np.argsort(~ii, -1)[:, 1:]  # the three opposite corners
            idx = np.arange(len(vv))
            pa = pp[idx, apex]
            va = vv[idx, apex]
            tri = np.stack([
                interp(pa, pp[idx, others[:, k]], va, vv[idx, others[:, k]])
                for k in range(3)], axis=1)
            if flip:
                tri = tri[:, ::-1]
            tri_list.append(tri)

        # two-inside: quad -> two triangles
        sel = (n_in == 2)
        if sel.any():
            vv, pp, ii = v[sel], p[sel], ins[sel]
            order = np.argsort(~ii, -1)
            a, b = order[:, 0], order[:, 1]      # inside
            c, d = order[:, 2], order[:, 3]      # outside
            idx = np.arange(len(vv))
            pac = interp(pp[idx, a], pp[idx, c], vv[idx, a], vv[idx, c])
            pad = interp(pp[idx, a], pp[idx, d], vv[idx, a], vv[idx, d])
            pbc = interp(pp[idx, b], pp[idx, c], vv[idx, b], vv[idx, c])
            pbd = interp(pp[idx, b], pp[idx, d], vv[idx, b], vv[idx, d])
            tri_list.append(np.stack([pac, pad, pbd], 1))
            tri_list.append(np.stack([pac, pbd, pbc], 1))

    tris = np.concatenate(tri_list, 0)  # (T, 3, 3)

    # weld duplicate vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat * 1e5).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    verts = flat[uniq_idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray
                           ) -> np.ndarray:
    """Area-weighted vertex normals."""
    n = np.zeros_like(verts)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None) -> None:
    """ASCII PLY writer (replaces trimesh export)."""
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n')
        f.write(f'element vertex {len(verts)}\n')
        f.write('property float x\nproperty float y\nproperty float z\n')
        if colors is not None:
            f.write('property uchar red\nproperty uchar green\n'
                    'property uchar blue\n')
        f.write(f'element face {len(faces)}\n')
        f.write('property list uchar int vertex_indices\nend_header\n')
        if colors is not None:
            for v, c in zip(verts, colors):
                f.write(f'{v[0]} {v[1]} {v[2]} '
                        f'{int(c[0])} {int(c[1])} {int(c[2])}\n')
        else:
            for v in verts:
                f.write(f'{v[0]} {v[1]} {v[2]}\n')
        for face in faces:
            f.write(f'3 {face[0]} {face[1]} {face[2]}\n')


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal ASCII PLY reader (verts + faces)."""
    with open(path) as f:
        assert f.readline().strip() == 'ply'
        n_verts = n_faces = 0
        props = 0
        line = f.readline()
        while line and line.strip() != 'end_header':
            parts = line.split()
            if parts[0] == 'element':
                if parts[1] == 'vertex':
                    n_verts = int(parts[2])
                elif parts[1] == 'face':
                    n_faces = int(parts[2])
            line = f.readline()
        verts = np.array([f.readline().split()[:3]
                          for _ in range(n_verts)], np.float32)
        faces = np.array([f.readline().split()[1:4]
                          for _ in range(n_faces)], np.int64)
    return verts.reshape(-1, 3), faces.reshape(-1, 3)
