"""anerf_torch's data layer (data/, native/, the utils the loop needs)
against anerf_tpu, on the CPU.

Both packages read the same synthetic h5 (written by the port's
make_synthetic_h5, whose arrays equal the JAX fixture's); the datasets
are seeded alike, so they draw the same pixels. Everything here is host
numpy (and the C++ sampler, built by g++ for both packages from their
own sources), so every comparison is exact: batches, items, meta and
fixtures are held equal value for value (the port's index arrays are
int64 where JAX's are int32). Two exceptions, each with its bound: the
super-batch against the per-item path, whose viewdirs are normalized in
C++ and in numpy (2e-7, 1 ulp, the JAX package's own bound); and the
metrics, float64 numpy in both packages, to 1e-12 relative.

Two sampler streams exist by design: the native path draws one seed per
item from the dataset's rng, the numpy path draws pixels from it
directly, so native is compared with native and numpy with numpy
(use_native=False). The loaders run one worker thread, which fixes the
order of the batches.
"""
import ast
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest

from anerf_tpu.data import dataset as jds
from anerf_tpu.data import fixtures as jfix
from anerf_tpu.data import pipeline as jpipe
from anerf_tpu.data import surreal as jsur
from anerf_tpu.ops import rays as jrays
from anerf_tpu.utils import metrics as jmet
from anerf_tpu.utils import skeleton_draw as jdraw

from anerf_torch import native
from anerf_torch.config import TrainConfig
from anerf_torch.data import catalog as tcat
from anerf_torch.data import dataset as tds
from anerf_torch.data import fixtures as tfix
from anerf_torch.data import pipeline as tpipe
from anerf_torch.data import schema as tschema
from anerf_torch.data import surreal as tsur
from anerf_torch.ops import rays as trays
from anerf_torch.utils import metrics as tmet
from anerf_torch.utils import skeleton_draw as tdraw
from anerf_torch.utils.logging import MetricsLogger

ROOT = Path(__file__).resolve().parents[1]
N_KPS, N_CAMS, HW = 4, 2, 32
N_PER = 8          # rays per image


@pytest.fixture(scope='module')
def h5_path(tmp_path_factory):
    p = tmp_path_factory.mktemp('torch_data') / 'syn_train_h5py.h5'
    tfix.make_synthetic_h5(str(p), n_kps=N_KPS, n_cams=N_CAMS, H=HW, W=HW)
    return str(p)


def _equal(a, b, what=''):
    """Exact equality of two (nested) batch values; None is None."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], tuple):
            for i, (g, w) in enumerate(zip(got[k], want[k])):
                _equal(g, w, f'{k}[{i}]')
        elif k == 'skel_type':
            assert got[k].joint_names == want[k].joint_names
        else:
            _equal(got[k], want[k], k)


# -------------------------------------------------------------- fixtures

@pytest.mark.parametrize('style', ['blobs', 'limbs', 'clutter'])
def test_synthetic_h5_matches_jax(tmp_path, style):
    kw = dict(n_kps=3, n_cams=2, H=24, W=24, seed=3, style=style)
    got = tfix.make_synthetic_h5(str(tmp_path / 't.h5'), **kw)
    want = jfix.make_synthetic_h5(str(tmp_path / 'j.h5'), **kw)
    _equal_dicts(got, want)
    _equal_dicts(tfix.synthetic_data(**kw), want)
    with h5py.File(tmp_path / 't.h5') as ft, h5py.File(tmp_path / 'j.h5') as fj:
        assert set(ft) == set(fj)
        for k in fj:
            assert ft[k].dtype == fj[k].dtype, k
            _equal(ft[k][()], fj[k][()], k)


def test_h5_arrays_is_the_file_read_back(h5_path):
    arrays = tschema.h5_arrays(tfix.synthetic_data(
        n_kps=N_KPS, n_cams=N_CAMS, H=HW, W=HW))
    with h5py.File(h5_path) as f:
        assert set(f) == set(arrays)
        for k in f:
            assert f[k].dtype == arrays[k].dtype, k
            _equal(arrays[k], f[k][()], k)
    assert tschema.dataset_keys(arrays) == list(arrays)


def test_world_to_cam_np_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 24, 3))
    ext = np.eye(4)
    ext[:3, 3] = [0.1, -0.2, 3.0]
    for focal, center in ((60.0, None), ([50.0, 55.0], (15.0, 17.0))):
        np.testing.assert_array_equal(
            trays.world_to_cam_np(pts, ext, 32, 30, focal, center),
            jrays.world_to_cam_np(pts, ext, 32, 30, focal, center))


# -------------------------------------------------------------- datasets

def _datasets(h5_path, kind='surreal', use_native=True, seed=11,
              source=None):
    kw = dict(N_samples=N_PER, split='train', seed=seed,
              use_native=use_native)
    tcls, jcls = ((tsur.SurrealDataset, jsur.SurrealDataset)
                  if kind == 'surreal'
                  else (tds.BaseH5Dataset, jds.BaseH5Dataset))
    return tcls(h5_path if source is None else source, **kw), \
        jcls(h5_path, **kw)


@pytest.mark.parametrize('kind', ['h5', 'surreal'])
def test_meta_and_render_data_match_jax(h5_path, kind):
    t, j = _datasets(h5_path, kind)
    assert len(t) == len(j) == N_KPS * N_CAMS
    _equal_dicts(t.get_meta(), j.get_meta())
    got, want = t.get_render_data(), j.get_render_data()
    if kind == 'surreal':
        # the port gives the camera of each image (the framecode row);
        # JAX gives the image index (surreal.py:get_render_data)
        np.testing.assert_array_equal(
            got.pop('cam_idxs'), np.arange(len(want['c2ws'])) // N_KPS)
        assert got.pop('cam_idxs_len') == N_CAMS
        want.pop('cam_idxs')
        want.pop('cam_idxs_len')
    _equal_dicts(got, want)


@pytest.mark.parametrize('use_native', [True, False])
def test_get_item_and_assemble_batch_match_jax(h5_path, use_native):
    t, j = _datasets(h5_path, use_native=use_native)
    assert (t._native is not None) == use_native
    for q in (0, 5, 3, 7):
        got, want = t.get_item(q), j.get_item(q)
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k], k)
        assert got['kp_idx'].dtype == np.int64
    idxs = np.array([1, 2, 6])
    got, want = tpipe.assemble_batch(t, idxs), jpipe.assemble_batch(j, idxs)
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k], k)
    for k in ('cam_idxs', 'pose_idx', 'kp_idxs'):
        assert got[k].dtype == np.int64, k


def test_super_batch_matches_jax_and_the_per_item_path(h5_path):
    t, j = _datasets(h5_path)
    idx_lists = [np.array([0, 3, 4]), np.array([1, 2, 7])]
    ops = t.super_operands()
    assert ops is not None
    got = tpipe.assemble_super_batch(t, idx_lists, ops)
    want = jpipe.assemble_super_batch(j, idx_lists, j.super_operands())
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k], k)
    # the per-item native path, seeded alike, stacked: the same pixels;
    # the viewdirs (rays[..., 8:]) are normalized in C++ here and in numpy
    # there, 1 ulp apart (the JAX package's own bound, test_dataset.py)
    t2, _ = _datasets(h5_path)
    per_item = [tpipe.assemble_batch(t2, i) for i in idx_lists]
    for k in got:
        want = np.stack([b[k] for b in per_item])
        if k == 'rays':
            _equal(got[k][..., :8], want[..., :8], k)
            np.testing.assert_allclose(got[k][..., 8:], want[..., 8:],
                                       rtol=2e-7, atol=2e-7)
        else:
            _equal(got[k], want, k)


@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('stack', [1, 3])
def test_batch_loader_sequence_matches_jax(h5_path, stack, use_native):
    from anerf_tpu.train.trainer import stack_batches as jstack
    from anerf_torch.train.trainer import stack_batches as tstack

    t, j = _datasets(h5_path, use_native=use_native)
    kw = dict(n_images=3, prefetch=2, seed=5, num_workers=1, stack=stack)
    tl = tpipe.BatchLoader(t, stack_fn=tstack, **kw)
    jl = jpipe.BatchLoader(j, stack_fn=jstack, **kw)
    assert (tl._super_ops is not None) == use_native
    tpipe.SUPER_BATCHES = tpipe.ITEM_BATCHES = 0
    try:
        tl.start()
        jl.start()
        for _ in range(4):
            got, want = tl.next(), jl.next()
            assert set(got) == set(want)
            for k in want:
                _equal(got[k], want[k], k)
                if stack > 1 and want[k] is not None:
                    assert got[k].shape[0] == stack
    finally:
        tl.stop()
        jl.stop()
    if use_native:
        assert tpipe.SUPER_BATCHES >= 4 and tpipe.ITEM_BATCHES == 0
    else:
        assert tpipe.SUPER_BATCHES == 0
        assert tpipe.ITEM_BATCHES >= 4 * stack


def test_batch_loader_synchronous_path(h5_path):
    """next() without start() assembles in the caller's thread, the same
    sequence as the worker thread's."""
    t, _ = _datasets(h5_path)
    t2, _ = _datasets(h5_path)
    kw = dict(n_images=2, seed=1, num_workers=1, stack=2)
    sync = tpipe.BatchLoader(t, **kw)
    threaded = tpipe.BatchLoader(t2, **kw).start()
    try:
        for _ in range(3):
            a, b = sync.next(), threaded.next()
            for k in a:
                _equal(a[k], b[k], k)
    finally:
        threaded.stop()
    assert not sync._threads and not threaded._threads


def test_in_memory_arrays_match_the_h5(h5_path):
    data = tfix.synthetic_data(n_kps=N_KPS, n_cams=N_CAMS, H=HW, W=HW)
    mem, _ = _datasets(h5_path, source=tschema.h5_arrays(data))
    disk, _ = _datasets(h5_path)
    _equal_dicts(mem.get_meta(), disk.get_meta())
    _equal_dicts(mem.get_render_data(), disk.get_render_data())
    for q in (2, 6):
        a, b = mem.get_item(q), disk.get_item(q)
        for k in a:
            _equal(a[k], b[k], k)
    idx_lists = [np.array([0, 5]), np.array([3, 4])]
    a = tpipe.assemble_super_batch(mem, idx_lists, mem.super_operands())
    b = tpipe.assemble_super_batch(disk, idx_lists, disk.super_operands())
    for k in a:
        _equal(a[k], b[k], k)


def test_concat_dataset_matches_jax(h5_path, tmp_path):
    other = str(tmp_path / 'second_train_h5py.h5')
    tfix.make_synthetic_h5(other, n_kps=3, n_cams=2, H=HW, W=HW, seed=5)
    t = tds.ConcatH5Dataset([_datasets(h5_path)[0],
                             _datasets(other, seed=2)[0]])
    j = jds.ConcatH5Dataset([_datasets(h5_path)[1],
                             _datasets(other, seed=2)[1]])
    assert len(t) == len(j) == 14
    _equal_dicts(t.get_meta(), j.get_meta())
    for q in (1, 9, 13):
        got, want = t.get_item(q), j.get_item(q)
        for k in want:
            _equal(got[k], want[k], k)


def test_native_sampler_is_built_from_the_ports_source():
    from anerf_tpu.native import get_fast_sampler as jget

    fs = native.get_fast_sampler()
    assert native.SOURCE == ROOT / 'anerf_torch/native/fast_sampler.cpp'
    assert fs.path.parent == ROOT / 'anerf_torch/_build'
    import hashlib
    digest = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:12]
    assert fs.path.name == f'fast_sampler_{digest}.so'
    assert native.build_fast_sampler() == fs.path
    # the same draws as the JAX package's extension, seed for seed
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=1000) > 0.7).astype(np.uint8)
    jfs = jget()
    for n, seed in ((16, 3), (400, 9)):    # without / with replacement
        got = fs.sample_mask_pixels(mask, n, seed)
        want = np.frombuffer(jfs.sample_mask_pixels(mask, n, seed),
                             np.int64)
        np.testing.assert_array_equal(got, want)
        assert np.all(np.diff(got) >= 0)
    with pytest.raises(TypeError):
        fs.sample_mask_pixels(mask.astype(np.int32), 4, 0)


def test_load_refined_raises(h5_path, tmp_path):
    """load_refined reads its pose checkpoint (pose/ckpt_compat.py; held
    against the JAX package in tests/test_torch_ckpt_compat.py): a
    missing one raises, an unlisted subject fails the assert."""
    class Refined(tds.PoseRefinedDataset):
        refined_paths = {'s': (str(tmp_path / 'x.tar'), False)}
    with pytest.raises(FileNotFoundError):
        Refined(h5_path, subject='s', load_refined=True)
    with pytest.raises(AssertionError, match='no refined pose path'):
        Refined(h5_path, subject='t', load_refined=True)
    ds = Refined(h5_path, subject='s', N_samples=N_PER, seed=0)
    assert len(ds) == N_KPS * N_CAMS


def test_catalog_builds_h5_and_surreal(h5_path, tmp_path, monkeypatch):
    args = TrainConfig(N_rand=16, N_sample_images=2)
    ds = tcat.get_dataset_from_catalog(args, 8, 'h5', h5_path)
    assert type(ds) is tds.BaseH5Dataset and len(ds) == 8
    (tmp_path / 'data' / 'surreal').mkdir(parents=True)
    shutil.copy(h5_path,
                tmp_path / tcat.DATASET_CATALOG['surreal']['female'])
    monkeypatch.chdir(tmp_path)
    ds = tcat.get_dataset_from_catalog(args, 8, 'surreal', 'female')
    assert type(ds) is tsur.SurrealDataset and ds.get_meta()['n_views'] == 2


@pytest.mark.parametrize('n_cams', [None, 2])
def test_surreal_rand_kps_matches_jax(tmp_path, monkeypatch, n_cams):
    """SurrealDataset's N_rand_kps path: the pose table it reads from
    data/surreal/surreal_rand_230.npy (a small one here, repeats
    included), the camera subset [0, 3, 6][:N_cams] of a 7-camera grid;
    meta and items equal to JAX's."""
    h5 = tmp_path / 'syn_train_h5py.h5'
    tfix.make_synthetic_h5(str(h5), n_kps=5, n_cams=7, H=8, W=8)
    (tmp_path / 'data' / 'surreal').mkdir(parents=True)
    np.save(tmp_path / 'data' / 'surreal' / 'surreal_rand_230.npy',
            np.array([3, 0, 4, 3]))
    monkeypatch.chdir(tmp_path)
    kw = dict(N_samples=N_PER, split='train', seed=5, N_rand_kps='230',
              N_cams=n_cams)
    t, j = tsur.SurrealDataset(str(h5), **kw), jsur.SurrealDataset(str(h5),
                                                                   **kw)
    want_cams = [0, 3, 6][:n_cams or 7]
    np.testing.assert_array_equal(
        t._idx_map, np.concatenate([np.array([0, 3, 4]) + 5 * c
                                    for c in want_cams]))
    assert len(t) == len(j) == 3 * len(want_cams)
    _equal_dicts(t.get_meta(), j.get_meta())
    for q in range(len(j)):
        got, want = t.get_item(q), j.get_item(q)
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k], f'{k}[{q}]')


# ------------------------------------------------------- utils of the loop

def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    rgbs = rng.uniform(size=(3, 20, 24, 3))
    gts = np.clip(rgbs + rng.normal(size=rgbs.shape) * 0.05, 0, 1)
    fgs = (rng.uniform(size=(3, 20, 24, 1)) > 0.4).astype(np.float32)
    boxes = np.array([[[2, 3], [20, 18]]] * 3)
    got = tmet.evaluate_metric_arrays(rgbs, gts, fgs=fgs, boxes=boxes)
    want = jmet.evaluate_metric_arrays(rgbs, gts, fgs=fgs, boxes=boxes)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
    x, y = rng.normal(size=(24, 3)), rng.normal(size=(24, 3))
    np.testing.assert_allclose(tmet.procrustes(x, y)[0],
                               jmet.procrustes(x, y)[0], rtol=1e-12)
    p, g = rng.normal(size=(4, 24, 3)), rng.normal(size=(4, 24, 3))
    assert tmet.mpjpe(p, g) == jmet.mpjpe(p, g)
    assert abs(tmet.pa_mpjpe(p, g) - jmet.pa_mpjpe(p, g)) < 1e-12


def test_skeleton_draw_matches_jax(h5_path):
    t, _ = _datasets(h5_path)
    rd = t.get_render_data()
    imgs = (rd['imgs'][:2] * 255).astype(np.uint8)
    H, W, focals = rd['hwf']
    args = (imgs, rd['kp3d'][:2], rd['c2ws'][:2], int(H[0]), int(W[0]),
            focals[:2])
    got, want = tdraw.draw_skeletons_3d(*args), jdraw.draw_skeletons_3d(*args)
    np.testing.assert_array_equal(got, want)
    assert (got != imgs).any()


def test_metrics_logger_writes_jsonl(tmp_path):
    import json
    log = MetricsLogger(str(tmp_path), use_tensorboard=False)
    log.log_scalars(3, {'loss': np.float32(0.5), 'psnr': 20})
    log.log_scalars(3, {'psnr': 21.0}, prefix='val/')
    log.close()
    recs = [json.loads(l) for l in
            (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert recs == [{'step': 3, 'loss': 0.5, 'psnr': 20.0},
                    {'step': 3, 'val/psnr': 21.0}]


def test_data_layer_imports_h5py_only_to_open_files():
    """The card's machine may lack h5py: no module of the port imports
    it at module level (only inside the functions that open a file)."""
    for path in sorted((ROOT / 'anerf_torch').rglob('*.py')):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any((n or '').split('.')[0] in ('h5py', 'imageio')
                           for n in names), path


def test_batch_counters_under_many_threads():
    """The loader's counters are bumped from its worker threads: no
    update is lost with more threads than cores and a short switch
    interval."""
    import sys
    import threading

    before = tpipe.SUPER_BATCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tpipe._count('SUPER_BATCHES') for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tpipe.SUPER_BATCHES - before == 16 * 2000
