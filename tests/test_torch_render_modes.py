"""anerf_torch's render-mode builders, render catalog, marching tetrahedra,
.ply I/O, software mesh renderer and turntable CLI against anerf_tpu's, on
the CPU.

Both sides are numpy on the same seeded inputs, so every array is held
bit for bit, except load_pose_rotate's: its root rotations go through
the ops/rotations conversions (JAX against torch, both f32 on the CPU),
whose sin / cos / atan2 may round an ulp apart; those are held to 1e-6
absolute (on values of order 1; the skts, 4x4 inverses of the posed
joints, to 1e-6 relative to their largest entry).
"""
import os

import numpy as np
import pytest

from anerf_tpu.render import catalog as jcat
from anerf_tpu.render import modes as jmodes
from anerf_tpu.skeleton import smpl_rest_pose
from anerf_tpu.utils import marching as jmarch
from anerf_tpu.utils import mesh_render as jmr

from anerf_torch.render import catalog as tcat
from anerf_torch.render import modes as tmodes
from anerf_torch.utils import marching as tmarch
from anerf_torch.utils import mesh_render as tmr


def _src_kw(rng, n=6, scalar_focal=False):
    rest = (smpl_rest_pose * 0.3).astype(np.float32)
    bones = (rng.normal(size=(n, 24, 3)) * 0.2).astype(np.float32)
    kps = rng.normal(size=(n, 24, 3)).astype(np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2ws[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32)
    c2ws[:, 2, 3] += 3.0
    focals = 100.0 if scalar_focal else \
        rng.uniform(80, 120, size=(n,)).astype(np.float32)
    return dict(kps=kps, bones=bones, c2ws=c2ws, focals=focals,
                rest_pose=rest)


def _sources(seed, scalar_focal=False):
    """(jax PoseSource, port PoseSource, jax refined, port refined) on
    the same arrays."""
    kw = _src_kw(np.random.default_rng(seed), scalar_focal=scalar_focal)
    ref = _src_kw(np.random.default_rng(seed + 1))
    return (jmodes.PoseSource(**kw), tmodes.PoseSource(**kw),
            jmodes.PoseSource(**ref), tmodes.PoseSource(**ref))


# the nine builders, each as (name, call(modes, src, other source))
BUILDERS = [
    ('camera_path', lambda m, s, r: {'c2ws': m.generate_camera_path(
        amp_wobble=10.0, dist=2.5, center=np.array([0.1, 0.2, 0.3]),
        n_cams=12)}),
    ('selected', lambda m, s, r: m.load_selected(
        s, np.array([4, 1, 3]), idx_map=np.arange(6)[::-1])),
    ('bullettime', lambda m, s, r: m.load_bullettime(
        s, np.array([0, 2]), n_bullet=5, undo_rot=True, center_kps=False)),
    ('interpolate', lambda m, s, r: m.load_interpolate(
        s, np.array([0, 2, 5]), n_step=4, center_cam=True)),
    ('animate', lambda m, s, r: m.load_animate(
        s, np.array([1, 3]), joints=[18, 19, 20, 21], n_step=3,
        center_kps=True, undo_rot=True)),
    ('retarget', lambda m, s, r: m.load_retarget(
        s, r, np.array([0, 2]), length=3, skip=2, center_kps=True,
        undo_rot=True)),
    ('pose_rotate', lambda m, s, r: m.load_pose_rotate(
        s, np.array([1]), n_bullet=9)),
    ('correction', lambda m, s, r: m.load_correction(
        s, r, np.array([0, 4]), n_step=3)),
    ('bubble', lambda m, s, r: m.load_bubble(
        s, np.array([0, 5]), n_step=4, z_t=0.2)),
]


@pytest.mark.parametrize('scalar_focal', [False, True])
@pytest.mark.parametrize('name,build', BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builder_matches_jax(name, build, scalar_focal):
    js, ts, jr, tr = _sources(3, scalar_focal)
    want = build(jmodes, js, jr)
    got = build(tmodes, ts, tr)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if name == 'pose_rotate' and k != 'cam_idxs':
            scale = max(np.abs(w).max(), 1.0) if k == 'skts' else 1.0
            np.testing.assert_allclose(g, w, atol=1e-6 * scale, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_small_helpers_match_jax():
    for fn in ('rotate_x', 'rotate_y', 'rotate_z'):
        np.testing.assert_array_equal(getattr(tmodes, fn)(0.7),
                                      getattr(jmodes, fn)(0.7))
    np.testing.assert_array_equal(tmodes.translate(1, 2, 3),
                                  jmodes.translate(1, 2, 3))
    c2w = _src_kw(np.random.default_rng(0))['c2ws'][:2]
    for axis in 'xyz':
        np.testing.assert_array_equal(
            tmodes.generate_bullet_time(c2w, 7, axis),
            jmodes.generate_bullet_time(c2w, 7, axis))
    np.testing.assert_array_equal(tmodes.UNDO_ROT, jmodes.UNDO_ROT)


def _same(a, b, where=''):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), where
        for k in b:
            _same(a[k], b[k], f'{where}/{k}')
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert np.asarray(a).dtype == b.dtype, where
    else:
        assert a == b and type(a) is type(b), where


@pytest.mark.parametrize('n_bullet', [10, 4])
def test_init_catalog_matches_jax(tmp_path, monkeypatch, n_bullet):
    """The same entries, indices and per-mode defaults, the index files
    under data/ read where they exist (the h36m val indices here)."""
    monkeypatch.chdir(tmp_path)
    _same(tcat.init_catalog(n_bullet), jcat.init_catalog(n_bullet))
    os.makedirs('data/h36m')
    np.save('data/h36m/S9_val_idxs.npy', np.arange(5, 40, 7))
    got, want = tcat.init_catalog(n_bullet), jcat.init_catalog(n_bullet)
    _same(got, want)
    assert got['h36m']['S9']['val']['selected_idxs'].tolist() == \
        list(range(5, 40, 7))


def _volume(seed, n=14):
    rng = np.random.default_rng(seed)
    t = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(t, t, t, indexing='ij')
    vol = 10.0 * (0.6 - np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2))
    return (vol + rng.normal(size=vol.shape)).astype(np.float32)


@pytest.fixture(scope='module')
def mesh():
    verts, faces = jmarch.marching_tetrahedra(_volume(0), 0.5)
    assert len(faces) > 100
    return verts, faces


@pytest.mark.parametrize('level', [0.5, -2.0, 100.0])
def test_marching_tetrahedra_matches_jax(level):
    vol = _volume(1)
    want = jmarch.marching_tetrahedra(vol, level)
    got = tmarch.marching_tetrahedra(vol, level)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tmarch.compute_vertex_normals(*got) if len(got[1]) else got[0],
        jmarch.compute_vertex_normals(*want) if len(want[1]) else want[0])


def test_ply_round_trip_across_packages(mesh, tmp_path):
    verts, faces = mesh
    colors = (np.abs(verts) * 200).astype(np.uint8)
    for tag, colored in (('plain', None), ('colored', colors)):
        a, b = str(tmp_path / f't_{tag}.ply'), str(tmp_path / f'j_{tag}.ply')
        tmarch.save_ply(a, verts, faces, colored)
        jmarch.save_ply(b, verts, faces, colored)
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
        for load in (tmarch.load_ply, jmarch.load_ply):
            v, f = load(a)
            np.testing.assert_array_equal(f, faces)
            np.testing.assert_allclose(v, verts, rtol=1e-6)


def test_mesh_render_images_match_jax(mesh):
    verts, faces = mesh
    np.testing.assert_array_equal(tmr.normalize_mesh(verts),
                                  jmr.normalize_mesh(verts))
    rot = jmr._rot_y(0.4)
    for kw in (dict(res=48), dict(res=40, zoom=0.6, samples_per_edge=3,
                                  bg=0.0)):
        np.testing.assert_array_equal(
            tmr.render_mesh_image(tmr.normalize_mesh(verts), faces, rot,
                                  **kw),
            jmr.render_mesh_image(jmr.normalize_mesh(verts), faces, rot,
                                  **kw))
    np.testing.assert_array_equal(
        tmr.render_turntable(verts, faces, step_deg=90.0, res=32),
        jmr.render_turntable(verts, faces, step_deg=90.0, res=32))
    img = np.random.default_rng(0).uniform(size=(40, 50, 3)).astype(
        np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = 4.0
    unit = jmr.normalize_mesh(verts)
    for focal in (60.0, (55.0, 65.0)):
        got = tmr.overlay_mesh_on_image(unit, faces, img, ext, focal)
        want = jmr.overlay_mesh_on_image(unit, faces, img, ext, focal)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, img)
    empty = np.zeros((0, 3), np.int64)
    np.testing.assert_array_equal(
        tmr.render_mesh_image(verts, empty, res=8),
        jmr.render_mesh_image(verts, empty, res=8))


def test_render_mesh_cli_matches_jax(mesh, tmp_path, monkeypatch):
    """python -m anerf_torch.render_mesh with the reference's flags (-ww /
    -hh, --basedir / --expname, --skip) writes the jpgs JAX's
    render_mesh.py writes, pixel for pixel."""
    import sys

    import imageio.v2 as imageio

    import render_mesh as jcli
    from anerf_torch import render_mesh as tcli

    verts, faces = mesh
    for base in ('t', 'j'):
        d = tmp_path / base / 'm1' / 'meshes'
        d.mkdir(parents=True)
        for i in range(3):
            tmarch.save_ply(str(d / f'{i:03d}.ply'), verts + 0.1 * i, faces)
    flags = ['-ww', '24', '-hh', '16', '--expname', 'm1', '--skip', '2',
             '--step_deg', '180']
    tcli.main(flags + ['--basedir', str(tmp_path / 't')])
    monkeypatch.setattr(sys, 'argv', ['render_mesh.py'] + flags
                        + ['--basedir', str(tmp_path / 'j')])
    jcli.main()
    t_out, j_out = (tmp_path / b / 'm1' / 'mesh_render' for b in 'tj')
    names = sorted(p.name for p in t_out.glob('*.jpg'))
    assert names == ['000_000.jpg', '000_001.jpg', '002_000.jpg',
                     '002_001.jpg']
    assert names == sorted(p.name for p in j_out.glob('*.jpg'))
    for n in names:
        a, b = imageio.imread(t_out / n), imageio.imread(j_out / n)
        assert a.shape[:2] == (24, 24)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match='no .ply'):
        tcli.main(['--basedir', str(tmp_path / 'nowhere')])
