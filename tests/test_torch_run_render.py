"""anerf_torch's render entry point (anerf_torch/run_render.py:
RenderSession, the stdin and TCP servers, --eval, --config, the mesh
density) against the JAX package's root run_render.py, on the CPU.

The model is the tiny one of tests/test_run_render_cli.py (netdepth 2,
width 32, f32, framecodes; 32x32 images of a 2-camera x 4-pose synthetic
SURREAL grid) on the plain branch, and a 6 x 256 bf16 one on the fused
branch, whose K1 takes its plain version on CPU tensors (the JAX side runs
its Pallas kernel in interpret mode). Both packages' RenderSessions load
the same JAX-exported reference .tar and the same h5; the render catalog
is cut to a few frames a mode in both (`_small_catalog`).

Framecode rows: the port maps a SURREAL image to its camera (image // 4
here), the JAX package passes the image index (which its gather clamps
past the table); the parity tests hand JAX the port's rows and
`test_surreal_framecode_rows` holds the difference itself.

Tolerances, each stated where it is used:
  * renders: rgbs / accs / disps within LIKE (5e-3 abs / rel,
    tests/test_torch_render.py), bboxes equal; the pose builders' arrays
    equal bit for bit (numpy both sides; pose rotation 1e-6).
  * --eval metrics 1e-4 relative (the same f32 renders, summed in another
    order).
  * the mesh density within LIKE of JAX's; chunked against unchunked
    1e-4 abs (the same products over fewer rows, summed in the CPU
    GEMM's own blocking).
"""
import argparse
import dataclasses
import io
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import run_render as jrr
import anerf_tpu.render.catalog as jcat
from anerf_tpu.config import TrainConfig as JTrainConfig
from anerf_tpu.config import save_args_txt as j_save_args_txt
from anerf_tpu.data.fixtures import make_synthetic_h5
from anerf_tpu.pose.ckpt_compat import export_reference_checkpoint
from anerf_tpu.render.factory import build_render_config as j_build_cfg
from anerf_tpu.render.factory import init_render_params as j_init_params
from anerf_tpu.render.raycaster import render_mesh_density as j_mesh_density
from anerf_tpu.render.raycaster import render_pts_density as j_pts_density
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL

import anerf_torch.render.catalog as tcat
from anerf_torch import run_render as trr
from anerf_torch.config import TrainConfig
from anerf_torch.convert import params_from_numpy
from anerf_torch.data.surreal import SurrealDataset
from anerf_torch.kernels import fused_render as tfr
from anerf_torch.render import raycaster as trc
from anerf_torch.render.factory import build_render_config as t_build_cfg
from anerf_torch.render.render_path import render_path as t_render_path
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.train import loop as tloop
from anerf_torch.train.trainer import derive_schedules

LIKE = dict(atol=5e-3, rtol=5e-3)
N_KPS, N_CAMS, HW = 4, 2, 32
SOCK_TIMEOUT = 120.0

# every render type; 'render_res' is a val request at 48 x 48
RTYPES = ('bullet', 'interpolate', 'animate', 'poserot', 'bubble',
          'retarget', 'selected', 'val', 'correction', 'render_res')


def _small_catalog(orig, h5):
    """The catalog cut to a few frames a mode, data_h5 the fixture."""
    def fake(n_bullet=10):
        c = orig(n_bullet)
        e = c['surreal']['female']
        e['data_h5'] = h5
        e['bullet'].update(selected_idxs=np.array([0, 2]), n_bullet=3)
        e['interpolate'].update(selected_idxs=np.array([0, 2]), n_step=3)
        e['animate'].update(selected_idxs=np.array([0, 2]), n_step=3)
        e['poserot'].update(n_bullet=3)
        e['bubble'].update(selected_idxs=np.array([0]), n_step=3)
        e['retarget'].update(selected_idxs=np.array([1, 3]))
        e['val'].update(selected_idxs=np.array([0, 3]))
        e['correction'] = {'selected_idxs': np.array([0, 2]), 'n_step': 2}
        return c
    return fake


def _exp_args(basedir, h5, fused):
    kw = dict(
        expname='fused' if fused else 'plain', basedir=str(basedir),
        dataset_type=('h5',), subject=(h5,), netdepth=2, netwidth=32,
        netwidth_fine=32, multires=3, multires_views=2, N_samples=8,
        N_importance=4, N_rand=64, N_sample_images=2, use_viewdirs=True,
        use_cutoff=True, cutoff_viewdir=True, cutoff_inputs=True,
        use_background=True, opt_framecode=True, ext_scale=0.001,
        raw_noise_std=1.0, chunk=1024, compute_dtype='float32',
        n_framecodes=N_CAMS, i_weights=2, i_testset=10 ** 8, i_print=2,
        n_iters=2, scan_unroll=1, num_workers=1, seed=0)
    if fused:
        kw.update(netdepth=6, netwidth=256, netwidth_fine=256,
                  compute_dtype='bfloat16', fused_kernel=True)
    return JTrainConfig(**kw)


def _render_args(exp, **over):
    base = dict(nerf_args=os.path.join(exp['dir'], 'args.txt'),
                ckptpath=exp['tar'], render_res=None, dataset='surreal',
                entry='female', white_bkgd=True, render_type='val',
                save_gt=False, fps=4, mesh_res=16, mesh_thres=5.0,
                mesh_overlay=False, render_refined=False, subject_idx=0,
                selected_idxs=None, selected_framecode=None,
                outputdir=os.path.join(exp['dir'], 'render_out'),
                runname='t', eval=False, no_save=True, coalesce=False)
    base.update(over)
    return argparse.Namespace(**base)


@pytest.fixture(scope='module')
def h5(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_run_render')
    p = str(tmp / 'syn_train_h5py.h5')
    data = make_synthetic_h5(p, n_kps=N_KPS, n_cams=N_CAMS, H=HW, W=HW)
    return p, data


def _make_exp(base, h5, data, fused):
    """args.txt + a JAX-exported reference .tar (random weights from
    PRNGKey(0), density heads lifted by 2 so the body shows, pose params
    of the h5's poses moved a little so correction mode has work)."""
    args = _exp_args(base, h5, fused)
    cfg = j_build_cfg(args, {'skel_type': JSMPL, 'n_views': N_CAMS})
    params = jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), args, cfg))
    for net in ('coarse', 'fine'):
        params[net]['alpha_linear']['b'] = \
            params[net]['alpha_linear']['b'] + 2.0
    exp_dir = os.path.join(str(base), args.expname)
    os.makedirs(exp_dir)
    j_save_args_txt(args, exp_dir)
    rng = np.random.default_rng(1)
    tar = os.path.join(exp_dir, 'model.tar')
    export_reference_checkpoint(
        tar, params, global_step=8, tau=20.0,
        pose_params={'pelvis': data['kp3d'][:, 0],
                     'bones': data['bones'] + rng.normal(
                         size=data['bones'].shape).astype(np.float32) * 0.1},
        rest_pose=data['rest_pose'])
    exp = {'dir': exp_dir, 'tar': tar, 'args': args, 'params': params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcat, 'init_catalog', _small_catalog(jcat.init_catalog,
                                                         h5))
        mp.setattr(tcat, 'init_catalog', _small_catalog(tcat.init_catalog,
                                                         h5))
        exp['jsess'] = jrr.RenderSession(_render_args(exp))
        exp['tsess'] = trr.RenderSession(_render_args(exp), device='cpu')
    return exp


@pytest.fixture(scope='module')
def plain(h5, tmp_path_factory):
    return _make_exp(tmp_path_factory.mktemp('plain'), *h5, fused=False)


@pytest.fixture(scope='module')
def fused(h5, tmp_path_factory):
    return _make_exp(tmp_path_factory.mktemp('fused'), *h5, fused=True)


def _request(rtype, **over):
    if rtype == 'render_res':
        return dict(render_type='val', render_res=[48, 48], **over)
    if rtype == 'selected':
        return dict(render_type='selected', selected_idxs=[1, 2], **over)
    return dict(render_type=rtype, **over)


def _both(exp, **req):
    """One request prepared and rendered by both sessions, JAX's with the
    port's framecode rows. Returns (jax out, port out, port prep)."""
    args = _render_args(exp, **req)
    jp, tp = exp['jsess'].prepare(args), exp['tsess'].prepare(args)
    for k in jp['data']:
        tol = 1e-6 if args.render_type == 'poserot' else 0.0
        np.testing.assert_allclose(np.asarray(tp['data'][k]),
                                   np.asarray(jp['data'][k]), atol=tol,
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(tp['cam_idxs'],
                                  np.asarray(jp['cam_idxs']) // N_KPS)
    jp = dict(jp, cam_idxs=tp['cam_idxs'])
    return (exp['jsess'].render_prepared([jp])[0],
            exp['tsess'].render_prepared([tp])[0], tp)


@pytest.mark.parametrize('rtype', RTYPES)
@pytest.mark.parametrize('branch', ['plain', 'fused'])
def test_render_types_match_jax(request, branch, rtype):
    exp = request.getfixturevalue(branch)
    assert exp['tsess'].cfg.use_fused == (branch == 'fused')
    before = tfr.LAUNCHES
    want, got, prep = _both(exp, **_request(rtype))
    assert tfr.LAUNCHES == before       # the CPU takes the plain version
    n = len(prep['data']['c2ws'])
    hw = (48, 48) if rtype == 'render_res' else (HW, HW)
    assert got['rgbs'].shape == (n, *hw, 3)
    np.testing.assert_array_equal(got['bboxes'], want['bboxes'])
    assert want['accs'].max() > 0.05
    for k in ('rgbs', 'accs', 'disps'):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LIKE)


def test_render_res_scales_the_box(plain):
    """--render_res keeps the field of view: at 48 / 32 of the native
    size the projected box grows by about that ratio."""
    _, native, _ = _both(plain, render_type='val')
    _, big, _ = _both(plain, render_type='val', render_res=[64, 64])
    for (tl_n, br_n), (tl_2, br_2) in zip(native['bboxes'], big['bboxes']):
        for d in range(2):
            ratio = (br_2[d] - tl_2[d]) / max(br_n[d] - tl_n[d], 1)
            assert 1.5 < ratio <= 2.5


@pytest.mark.parametrize('render_res', [None, [48, 48]])
def test_eval_matches_jax(plain, render_res):
    """--eval: box-cropped PSNR / SSIM of val renders (images 0 and 3,
    both on framecode row 0 through selected_framecode, so the packages'
    rows agree) within 1e-4 relative; at a non-native resolution the GT
    goes through cv2's resize."""
    args = _render_args(plain, render_type='val', eval=True,
                        render_res=render_res, runname='ev',
                        selected_framecode=0)
    want = plain['jsess'].render_once(args)['eval']
    got = plain['tsess'].render_once(args)['eval']
    assert set(got) == set(want) and np.isfinite(got['psnr'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert os.path.exists(os.path.join(plain['dir'], 'render_out',
                                       'surreal', 'ev', 'metrics.txt'))


def test_eval_rejects_non_1to1_modes(plain):
    args = _render_args(plain, render_type='bullet', eval=True)
    with pytest.raises(ValueError, match='--eval'):
        plain['tsess'].render_once(args)


@pytest.mark.parametrize('branch', ['plain', 'fused'])
def test_mesh_density_matches_jax(request, branch):
    """render_mesh_density against JAX's on a 17^3 grid within LIKE on
    both MLPs (observed 2.6e-5 on the f32 one, 4.9e-4 on the bf16 one,
    densities up to 2.1); the chunked query against the one-chunk one
    within 1e-4 (observed 0 to 2.6e-5: the CPU's f32 GEMM may block its
    sums otherwise for another row count)."""
    exp = request.getfixturevalue(branch)
    src = exp['tsess'].src
    from anerf_torch.ops.fk import get_smpl_l2ws_np
    l2ws = get_smpl_l2ws_np(src.bones[0], src.rest_pose)
    l2ws[..., :3, -1] += src.kps[0, :1]
    kps = l2ws[..., :3, -1][None].astype(np.float32)
    skts = np.linalg.inv(l2ws)[None].astype(np.float32)
    bones = src.bones[:1].astype(np.float32)
    want = np.asarray(j_mesh_density(
        exp['params'], exp['jsess'].cfg, jnp.asarray(kps),
        jnp.asarray(skts), jnp.asarray(bones), radius=1.3, res=16,
        tau=jnp.float32(20.0)))
    t = lambda x: torch.as_tensor(x)
    got = trc.render_mesh_density(exp['tsess'].params, exp['tsess'].cfg,
                                  t(kps), t(skts), t(bones), radius=1.3,
                                  res=16, tau=20.0).numpy()
    chunked = trc.render_mesh_density(
        exp['tsess'].params, exp['tsess'].cfg, t(kps), t(skts), t(bones),
        radius=1.3, res=16, tau=20.0, chunk=1000).numpy()
    assert got.shape == want.shape == (17, 17, 17)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, **LIKE)
    np.testing.assert_allclose(chunked, got, atol=1e-4, rtol=0)


def test_pts_density_output_head_matches_jax(h5, tmp_path):
    """use_viewdirs=False: the density is output_linear's channel 3."""
    args = dataclasses.replace(_exp_args(tmp_path, h5[0], False),
                               use_viewdirs=False, cutoff_viewdir=False)
    jcfg = j_build_cfg(args, {'skel_type': JSMPL, 'n_views': N_CAMS})
    params = jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(3), args, jcfg))
    assert 'output_linear' in params['fine']
    tcfg = t_build_cfg(TrainConfig(**dataclasses.asdict(args)),
                       {'skel_type': SMPLSkeleton, 'n_views': N_CAMS})
    data = h5[1]
    rng = np.random.default_rng(2)
    pts = (data['kp3d'][0, :1] + rng.normal(size=(1, 300, 3)) * 0.3
           ).astype(np.float32)
    skts = data['skts'][:1].astype(np.float32)
    kps = data['kp3d'][:1].astype(np.float32)
    want = np.asarray(j_pts_density(params, jcfg, jnp.asarray(pts),
                                    jnp.asarray(kps), jnp.asarray(skts),
                                    None, jnp.float32(20.0)))
    got = trc.render_pts_density(params_from_numpy(params, 'cpu'), tcfg,
                                 torch.as_tensor(pts), torch.as_tensor(kps),
                                 torch.as_tensor(skts), None, 20.0,
                                 chunk=128).numpy()
    assert got.shape == want.shape == (1, 300, 1)
    np.testing.assert_allclose(got, want, **LIKE)


def test_mesh_request_writes_a_ply(plain, monkeypatch):
    """A mesh request (threshold halfway through the grid's densities)
    writes a .ply that reads back, and launches no kernel."""
    from anerf_torch.utils.marching import load_ply
    grids = []
    density = trc.render_mesh_density

    def spy(*a, **kw):
        grids.append(density(*a, **kw))
        return grids[-1]
    monkeypatch.setattr(trc, 'render_mesh_density', spy)
    args = _render_args(plain, render_type='mesh', runname='mesh0')
    plain['tsess'].render_once(args)
    g = grids[0].numpy()
    args = _render_args(plain, render_type='mesh', runname='mesh',
                        mesh_thres=float(g.min() + g.max()) / 2)
    before = tfr.LAUNCHES
    out = plain['tsess'].render_once(args)
    assert tfr.LAUNCHES == before
    (m,) = out['meshes']
    verts, faces = load_ply(m['path'])
    assert len(verts) == m['n_verts'] > 0 and len(faces) == m['n_faces']
    assert faces.max() < len(verts)


def test_surreal_framecode_rows(plain):
    """The SURREAL framecode fault of the JAX package: image 2 is camera
    0, pose 2; the JAX session passes row 2 of a 2-row table, which its
    gather clamps to the last row, so its render equals the one with
    selected_framecode 1. The port renders camera 0's row (equal to JAX's
    with selected_framecode 0) and refuses a row past the table."""
    js, ts = plain['jsess'], plain['tsess']

    def jax_render(**req):
        args = _render_args(plain, render_type='val', selected_idxs=[2],
                            **req)
        return js.render_prepared([js.prepare(args)])[0]

    clamped, last = jax_render(), jax_render(selected_framecode=1)
    np.testing.assert_array_equal(clamped['rgbs'], last['rgbs'])
    camera0 = jax_render(selected_framecode=0)
    assert np.abs(camera0['rgbs'] - last['rgbs']).max() > 1e-3

    args = _render_args(plain, render_type='val', selected_idxs=[2])
    prep = ts.prepare(args)
    assert prep['cam_idxs'].tolist() == [0]
    got = ts.render_prepared([prep])[0]
    np.testing.assert_allclose(got['rgbs'], camera0['rgbs'], **LIKE)
    with pytest.raises(ValueError, match='outside the table of 2'):
        ts.prepare(_render_args(plain, render_type='val',
                                selected_idxs=[2], selected_framecode=5))


def _serve_lines(serve, exp, sess, lines, **over):
    """The reply lines of `serve` (JAX's loads its own session; the
    port's is given `sess`) to the request `lines`."""
    stdout = io.StringIO()
    kw = {} if sess is None else {'session': sess}
    serve(_render_args(exp, **over),
          stdin=io.StringIO(''.join(ln + '\n' for ln in lines)),
          stdout=stdout, **kw)
    return [json.loads(ln) for ln in stdout.getvalue().splitlines()]


PROTOCOL = [
    json.dumps({'render_type': 'val', 'runname': 'p1', 'eval': True}),
    json.dumps({'render_type': 'val', 'bogus_field': 1}),
    'not json',
    '[1, 2]',
    json.dumps({'render_type': 'bullet', 'runname': 'p2'}),
    json.dumps({'render_type': 'nosuch', 'runname': 'p3'}),
    json.dumps({'render_type': 'bullet', 'eval': True}),
    json.dumps({'render_type': 'correction', 'selected_idxs': [0],
                'runname': 'p4'}),
    '',
    json.dumps({'render_type': 'val', 'selected_idxs': [0],
                'runname': 'p5'}),
    json.dumps({'cmd': 'quit'}),
    json.dumps({'render_type': 'val', 'runname': 'dropped'}),
]
TIMES = ('load_seconds', 'seconds', 'render_seconds', 'batch_seconds')


@pytest.mark.parametrize('coalesce', [False, True])
def test_stdin_protocol_matches_jax(plain, monkeypatch, coalesce):
    """The same request lines through JAX's serve and the port's: the
    same replies in the same order (keys, ok, errors, frame counts, eval
    within 1e-4, the quit reply, nothing after it); with --coalesce the
    five renderable requests queued together share one render_path
    call."""
    monkeypatch.setattr(jcat, 'init_catalog',
                        _small_catalog(jcat.init_catalog, plain['jsess']
                                       .data_h5))
    # selected_framecode 0: the packages' framecode rows agree
    want = _serve_lines(jrr.serve, plain, None, PROTOCOL,
                        coalesce=coalesce, selected_framecode=0)
    got = _serve_lines(trr.serve, plain, plain['tsess'], PROTOCOL,
                       coalesce=coalesce, selected_framecode=0)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for k in w:
            if k == 'eval':
                for m in w[k]:
                    np.testing.assert_allclose(g[k][m], w[k][m], rtol=1e-4)
            elif k not in TIMES:
                assert g[k] == w[k], (k, g, w)
    ok = [r['ok'] for r in got]
    assert ok == [True, True, False, False, False, True, False, False,
                  True, True, True]
    assert got[-1] == {'ok': True, 'bye': True}
    assert got[1]['n_frames'] == 2 and got[5]['n_frames'] == 6
    assert got[8]['n_frames'] == 2           # correction: 1 pose x 2 steps
    assert got[9]['n_frames'] == 1
    assert got[1].get('batched', 1) == (5 if coalesce else 1)
    assert 'bogus_field' in got[2]['error']


def test_stdin_server_eof_and_load(plain, monkeypatch):
    """EOF right after the ready line ends both servers; a session the
    server loads itself (from args, on the CPU) answers like the given
    one."""
    monkeypatch.setattr(jcat, 'init_catalog',
                        _small_catalog(jcat.init_catalog, plain['jsess']
                                       .data_h5))
    for serve, sess in ((jrr.serve, None), (trr.serve, plain['tsess'])):
        lines = _serve_lines(serve, plain, sess, [])
        assert len(lines) == 1 and lines[0]['ready'], lines
    monkeypatch.setattr(tcat, 'init_catalog',
                        _small_catalog(tcat.init_catalog, plain['jsess']
                                       .data_h5))
    stdout = io.StringIO()
    trr.serve(_render_args(plain), stdin=io.StringIO(
        json.dumps({'render_type': 'val', 'runname': 'own'}) + '\n'),
        stdout=stdout, device='cpu')
    ready, rep = map(json.loads, stdout.getvalue().splitlines())
    assert ready['ready'] and rep['ok'] and rep['n_frames'] == 2


def _client(port, reqs, out, key):
    with socket.create_connection(('127.0.0.1', port),
                                  timeout=SOCK_TIMEOUT) as s:
        f = s.makefile('r', encoding='utf-8')
        for r in reqs:
            s.sendall((json.dumps(r) + '\n').encode())
        out[key] = [json.loads(f.readline()) for _ in reqs]


def test_tcp_concurrent_clients(plain):
    """serve_tcp on an ephemeral port in a thread; two client threads
    each send two requests at once and get their own replies in their
    own order; a client that vanishes closes only its connection; a bad
    request gets an error reply; quit stops the server. Every socket
    operation has a timeout, every join a deadline."""
    ready = threading.Event()

    class Ready(io.StringIO):
        def flush(self):
            if self.getvalue():
                ready.set()

    stdout = Ready()
    server = threading.Thread(target=trr.serve_tcp, args=(
        _render_args(plain),), kwargs=dict(port=0, stdout=stdout,
                                           session=plain['tsess']),
        daemon=True)
    server.start()
    assert ready.wait(SOCK_TIMEOUT)
    port = json.loads(stdout.getvalue().splitlines()[0])['port']
    assert port > 0

    out = {}
    clients = [threading.Thread(target=_client, args=(port, [
        {'render_type': 'val', 'selected_idxs': [c], 'runname': f'c{c}_{j}'}
        for j in range(2)], out, c)) for c in (0, 3)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(SOCK_TIMEOUT)
        assert not t.is_alive()
    for c in (0, 3):
        assert [r['runname'] for r in out[c]] == [f'c{c}_0', f'c{c}_1']
        assert all(r['ok'] and r['n_frames'] == 1 for r in out[c])

    socket.create_connection(('127.0.0.1', port),
                             timeout=SOCK_TIMEOUT).close()
    with socket.create_connection(('127.0.0.1', port),
                                  timeout=SOCK_TIMEOUT) as s:
        f = s.makefile('r', encoding='utf-8')
        s.sendall(b'{"bogus": 1}\n')
        rep = json.loads(f.readline())
        assert not rep['ok'] and 'bogus' in rep['error']
        s.sendall(b'{"cmd": "quit"}\n')
        assert json.loads(f.readline()) == {'ok': True, 'bye': True}
    server.join(SOCK_TIMEOUT)
    assert not server.is_alive()


def test_config_expansion_matches_jax(tmp_path):
    cfg = tmp_path / 'render.txt'
    cfg.write_text(
        'nerf_args = /x/args.txt\n'
        'ckptpath = /x/ckpt.tar\n'
        'dataset = surreal\n'
        'entry = female\n'
        'runname = fromfile\n'
        'render_type = bullet\n'
        'white_bkgd = True\n'
        'eval = False\n'
        'selected_idxs = [0, 2, 5]\n'
        'render_res = 64 48  # comment after a value\n'
        '# comment line\n'
        'config = ignored.txt\n')
    tokens = trr._argv_from_config(str(cfg))
    assert tokens == jrr._argv_from_config(str(cfg))
    args = trr.config_parser().parse_args(tokens + ['--runname', 'cli'])
    want = jrr.config_parser().parse_args(tokens + ['--runname', 'cli'])
    assert vars(args) == vars(want)
    assert args.selected_idxs == [0, 2, 5] and args.runname == 'cli'
    assert args.white_bkgd is True and args.eval is False


def test_main_one_shot_from_config(plain, monkeypatch):
    """main(argv) with --config, on the CPU; without device='cpu' it
    refuses a host without CUDA."""
    monkeypatch.setattr(tcat, 'init_catalog',
                        _small_catalog(tcat.init_catalog, plain['jsess']
                                       .data_h5))
    cfg = os.path.join(plain['dir'], 'render.txt')
    with open(cfg, 'w') as f:
        f.write(f"nerf_args = {plain['dir']}/args.txt\n"
                f"ckptpath = {plain['tar']}\n"
                'dataset = surreal\nentry = female\nrender_type = val\n'
                'runname = main1\neval = True\n'
                f"outputdir = {plain['dir']}/render_out\n")
    out = trr.main(['--config', cfg], device='cpu')
    assert out['rgbs'].shape == (2, HW, HW, 3)
    assert np.isfinite(out['eval']['psnr'])
    img_dir = os.path.join(plain['dir'], 'render_out', 'surreal', 'main1',
                           'image')
    assert len(os.listdir(img_dir)) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trr.main(['--config', cfg])


def test_native_checkpoint_renders_like_render_path(h5, tmp_path):
    """A checkpoint of the port's own training loop (2 steps) loads
    through setup() (no loader thread left running) and renders what
    render_path renders on the trained params at the restored step's
    tau, bit for bit."""
    path, _ = h5
    args = TrainConfig(**dataclasses.asdict(_exp_args(tmp_path, path,
                                                      False)))
    ds = SurrealDataset(path, N_samples=32, split='train', seed=0)
    ctx = tloop.train(args, ds, device='cpu', save_images=False)
    assert ctx.state.step == 2
    exp = {'dir': ctx.exp_dir, 'tar': os.path.join(ctx.exp_dir,
                                                   'checkpoints')}
    before = set(threading.enumerate())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcat, 'init_catalog', _small_catalog(tcat.init_catalog,
                                                         path))
        sess = trr.RenderSession(_render_args(exp), device='cpu')
    assert not set(threading.enumerate()) - before   # no thread started
    tau, _ = derive_schedules(args, ctx.cfg, 2)
    assert sess.tau == tau
    for a, b in zip(jax.tree.leaves(sess.params),
                    jax.tree.leaves(ctx.state.params)):
        assert torch.equal(a, b)
    prep = sess.prepare(_render_args(exp, render_type='bullet'))
    got = sess.render_prepared([prep])[0]
    d = prep['data']
    want = t_render_path(ctx.state.params, ctx.cfg, d['c2ws'],
                         (HW, HW, d['focals']), d['kp3d'], d['skts'],
                         d['bones'], cam_idxs=prep['cam_idxs'], tau=tau,
                         chunk=args.chunk, ext_scale=args.ext_scale,
                         use_framecode_idx=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['accs'].max() > 0.05
