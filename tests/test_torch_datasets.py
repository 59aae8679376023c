"""anerf_torch's dataset types (data/h36m.py, perfcap.py, mixamo.py,
zju.py, mpi3dhp.py, catalog.py and the port's fixtures of their layouts)
against anerf_tpu's classes on the same h5, on the CPU.

Each type's h5 is written from the port's fixture (data/fixtures.py);
both packages read that file, the port also its in-memory H5Arrays. The
two must agree value for value: get_meta, get_item on the native and
numpy routes (seeded alike), the whole-dispatch super-batch where the
type has one (H36M, ZJU) and the per-item route where it does not
(temporal validity: MonoPerfCap, Mixamo, 3DHP), get_render_data,
kp_map / kp_uidxs and temp_validity. Exact equality everywhere except
the refined poses (1e-5, the bound of tests/test_torch_ckpt_compat.py:
6D -> axis-angle through each package's own rotation ops) and ZJU's
render framecode rows, where the port gives the row get_item trains
(ROADMAP.md Queue 3).
"""
import os

import numpy as np
import pytest
import torch

from anerf_tpu.config import TrainConfig as JTrainConfig
from anerf_tpu.data import catalog as jcat
from anerf_tpu.data import h36m as jh36m
from anerf_tpu.data import mixamo as jmix
from anerf_tpu.data import mpi3dhp as j3dhp
from anerf_tpu.data import perfcap as jperf
from anerf_tpu.data import pipeline as jpipe
from anerf_tpu.data import zju as jzju
from anerf_tpu.pose import ckpt_compat as jcc

from anerf_torch.config import TrainConfig
from anerf_torch.data import catalog as tcat
from anerf_torch.data import fixtures as tfix
from anerf_torch.data import h36m as th36m
from anerf_torch.data import mixamo as tmix
from anerf_torch.data import mpi3dhp as t3dhp
from anerf_torch.data import perfcap as tperf
from anerf_torch.data import pipeline as tpipe
from anerf_torch.data import schema as tschema
from anerf_torch.data import zju as tzju
from anerf_torch.pose import ckpt_compat as tcc

from test_torch_data import _equal, _equal_dicts

HW = 24
N_PER = 6          # rays per image

# kind -> (port class, JAX class, subject, catalog file name, fixture)
TYPES = {
    'h36m': (th36m.H36MDataset, jh36m.H36MDataset, 'S9',
             lambda: tfix.h36m_data(n_instants=2, H=HW, W=HW)),
    'perfcap': (tperf.MonoPerfCapDataset, jperf.MonoPerfCapDataset,
                'weipeng', lambda: tfix.perfcap_data(n_frames=6, H=HW, W=HW)),
    'mixamo': (tmix.MixamoDataset, jmix.MixamoDataset, 'james',
               lambda: tfix.mixamo_data(n_frames=3, n_cams=2, H=HW, W=HW)),
    'zju': (tzju.ZJUMocapDataset, jzju.ZJUMocapDataset, '377',
            lambda: tfix.zju_data(n_frames=3, n_cams=3, H=HW, W=HW)),
    '3dhp': (t3dhp.ThreeDHPDataset, j3dhp.ThreeDHPDataset, 'S1',
             lambda: tfix.mpi3dhp_data(n_frames=10, H=HW, W=HW)),
}
KINDS = list(TYPES)
NATIVE = ('h36m', 'zju')        # the types the super-batch path takes


def _layout(root, kind, data=None):
    """The type's fixture written at its catalog path under `root`
    (Mixamo's selection beside it); returns (path, arrays)."""
    subject = TYPES[kind][2]
    path = os.path.join(str(root), jcat.DATASET_CATALOG[kind][subject])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if data is None:
        data = TYPES[kind][3]()
    if kind == 'mixamo':
        data, selected = data
        np.save(tmix.selected_path(path), selected)
    tschema.write_h5(path, data)
    return path, tschema.h5_arrays(data, path=path)


@pytest.fixture(scope='module')
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_datasets')
    return {k: _layout(root, k) for k in KINDS}


def _pair(layouts, kind, source='path', use_native=True, seed=5, **kw):
    tcls, jcls, subject, _ = TYPES[kind]
    path, arrays = layouts[kind]
    kw = dict(dict(N_samples=N_PER, split='full', subject=subject,
                   seed=seed, use_native=use_native), **kw)
    return tcls(path if source == 'path' else arrays, **kw), \
        jcls(path, **kw)


@pytest.mark.parametrize('source', ['path', 'arrays'])
@pytest.mark.parametrize('kind', KINDS)
def test_meta_and_render_data_match_jax(layouts, kind, source):
    t, j = _pair(layouts, kind, source)
    assert len(t) == len(j) > 0
    _equal_dicts(t.get_meta(), j.get_meta())
    got, want = t.get_render_data(), j.get_render_data()
    if kind == 'zju':
        # the framecode row get_item trains (the image's place in the
        # split); JAX gives the image's camera (zju.py:get_render_data)
        skip, n = t.render_skip, t.N_render
        np.testing.assert_array_equal(
            got.pop('cam_idxs'), np.arange(len(t))[::skip][:n])
        assert got.pop('cam_idxs_len') == len(t)
        np.testing.assert_array_equal(
            want.pop('cam_idxs'), t.cam_idxs_table[::skip][:n])
        want.pop('cam_idxs_len')
    _equal_dicts(got, want)
    for name in ('kp_map', 'kp_uidxs', 'temp_validity', 'c2ws', 'focals',
                 'centers', 'bgs', 'bg_idxs', '_idx_map'):
        _equal(getattr(t, name, None), getattr(j, name, None), name)
    assert (t.temp_validity is None) == (kind in NATIVE)


@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('kind', KINDS)
def test_get_item_and_batches_match_jax(layouts, kind, use_native):
    t, j = _pair(layouts, kind, 'arrays', use_native=use_native)
    assert (t._native is not None) == use_native
    for q in (0, len(t) - 1, 3, 1):
        got = t.get_item(q)
        if kind == 'mixamo':
            # the port reads the validity at the image's place in the
            # selection, where it was computed; JAX at the image index,
            # past the selection's end for the last images (ROADMAP.md
            # Queue 3)
            v = t.temp_validity
            assert got.pop('temp_val') == (v[q] + v[(q + 1) % len(v)]) // 2
            if t._idx_map[q] >= len(v):
                with pytest.raises(IndexError):
                    j.get_item(q)
                continue
        want = j.get_item(q)
        want.pop('temp_val', None) if kind == 'mixamo' else None
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k], f'{kind} item {q} {k}')
    idxs = np.array([0, 2, 3])
    got, want = tpipe.assemble_batch(t, idxs), jpipe.assemble_batch(j, idxs)
    assert set(got) == set(want) and ('temp_val' in got) == (
        kind not in NATIVE)
    if kind == 'mixamo':
        v = t.temp_validity
        _equal(got.pop('temp_val'),
               [(v[q] + v[(q + 1) % len(v)]) // 2 for q in idxs])
        want.pop('temp_val')
    for k in want:
        _equal(got[k], want[k], k)


@pytest.mark.parametrize('kind', KINDS)
def test_super_batch_route_matches_jax(layouts, kind):
    """H36M and ZJU take the native whole-dispatch route (ZJU with its
    per-camera centers and two focals), each batch equal to JAX's; the
    temporal types take the per-item route in both packages."""
    t, j = _pair(layouts, kind, 'arrays')
    ops = t.super_operands()
    if kind not in NATIVE:
        assert ops is None and j.super_operands() is None
        return
    idx_lists = [np.array([0, 2, 5]), np.array([1, 3, 4])]
    got = tpipe.assemble_super_batch(t, idx_lists, ops)
    want = jpipe.assemble_super_batch(j, idx_lists, j.super_operands())
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k], k)


@pytest.mark.parametrize('split', ['train', 'val'])
def test_h36m_sequence_split_and_single_camera_subset(layouts, split):
    t, j = _pair(layouts, 'h36m', split=split)
    _equal(t._idx_map, j._idx_map, 'idx_map')
    # the fixture's second sequence, Walking-1, is a validation sequence
    assert len(t) == 8
    _equal_dicts(t.get_meta(), j.get_meta())
    got, want = t.get_item(2), j.get_item(2)
    for k in want:
        _equal(got[k], want[k], k)
    t, j = _pair(layouts, 'h36m', subject='S9c')
    _equal(t._idx_map, j._idx_map, 'S9c')
    assert len(t) == 16            # both sequences end in '-1'


@pytest.mark.parametrize('source', ['path', 'arrays'])
def test_h36m_multiview_pose_sharing_matches_jax(layouts, source):
    t, j = _pair(layouts, 'h36m', source, multiview=True)
    for name in ('kp_map', 'kp_uidxs', 'kp3d', 'bones', 'skts', 'cyls'):
        _equal(getattr(t, name), getattr(j, name), name)
    # 2 sequences x 2 instants, each shared by the 4 cameras' images
    assert t.kp_map.tolist() == [0, 1] * 4 + [2, 3] * 4
    _equal_dicts(t.get_meta(), j.get_meta())
    _equal_dicts(t.get_render_data(), j.get_render_data())
    got, want = t.get_item(5), j.get_item(5)
    for k in want:
        _equal(got[k], want[k], k)
    for p in (layouts['h36m'][1]['img_paths'][[0, 9]],
              ['S9/Walking-1/imageSequence/x/img_000000.jpg']):
        _equal(th36m.find_motion_set(p)[2], jh36m.find_motion_set(p)[2])


def test_perfcap_tail_split_camera_fix_and_validity(tmp_path):
    """The tail-n validation split (weipeng: the last 230 frames) on a
    sequence long enough to hold it, the 1.05 camera fix and the
    temporal validity over the training frames."""
    data = tfix.perfcap_data(n_frames=236, H=8, W=8)
    layouts = {'perfcap': _layout(tmp_path, 'perfcap', data)}
    for split, n in (('train', 6), ('val', 230), ('full', 236)):
        t, j = _pair(layouts, 'perfcap', 'arrays', split=split)
        assert len(t) == len(j) == n
        for name in ('_idx_map', 'temp_validity', 'c2ws'):
            _equal(getattr(t, name), getattr(j, name), name)
        _equal_dicts(t.get_meta(), j.get_meta())
    np.testing.assert_allclose(t.c2ws[:, :3, 3] * 1.05,
                               data['c2ws'][:, :3, 3], rtol=1e-6)


def test_mixamo_selection_and_temporal_validity(layouts):
    t, j = _pair(layouts, 'mixamo')
    path, arrays = layouts['mixamo']
    sel = np.load(tmix.selected_path(path))
    _equal(t._idx_map, np.sort(sel))
    assert len(t) == len(sel) == 11
    # the first frame of each directory, and the gap the selection leaves
    # (image 7 is dropped), are temporally invalid
    assert t.temp_validity.tolist() == [0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1]
    paths = arrays['img_paths'][t._idx_map]
    for a, b in zip(tmix.get_temporal_validity(paths),
                    jmix.get_temporal_validity(paths)):
        _equal(a, b)
    assert (t.bgs == 255).all() and t.has_bg
    # an H5Arrays without a path cannot find its selection
    bare = tschema.H5Arrays(arrays)
    bare.path = None
    with pytest.raises(ValueError, match='no file path'):
        tmix.MixamoDataset(bare, N_samples=N_PER, subject='james')


@pytest.mark.parametrize('subject', ['S2', 'S5'])
def test_3dhp_val_split_and_subject_fixes(layouts, subject):
    for split in ('train', 'val'):
        t, j = _pair(layouts, '3dhp', 'arrays', split=split,
                     subject=subject)
        assert len(t) == (10 if split == 'train' else 2)
        for name in ('_idx_map', 'bgs', 'c2ws', 'temp_validity'):
            _equal(getattr(t, name), getattr(j, name), name)
        _equal_dicts(t.get_meta(), j.get_meta())
    if subject == 'S2':
        assert not t.bgs.any()


def test_zju_test_split_and_h36m_variant(layouts, tmp_path):
    """ZJU's test split is the file beside the train file ('train' ->
    'test' in the path, for arrays in their H5Arrays.path); ZJUH36M's
    split holds out the last 30 images."""
    path, arrays = layouts['zju']
    test_path = path.replace('train', 'test')
    tschema.write_h5(test_path, tfix.zju_data(n_frames=4, n_cams=3, H=HW,
                                              W=HW, seed=3))
    for source in (path, arrays):
        t = tzju.ZJUMocapDataset(source, N_samples=N_PER, split='test',
                                 seed=1)
        j = jzju.ZJUMocapDataset(path, N_samples=N_PER, split='test', seed=1)
        assert t.h5_path == j.h5_path == test_path
        _equal(t.kp_idxs_table, j.kp_idxs_table)
        _equal_dicts(t.get_meta(), j.get_meta())
    data = tfix.zju_data(n_frames=12, n_cams=3, H=8, W=8)
    p = str(tmp_path / 'zh_train_h5py.h5')
    tschema.write_h5(p, data)
    for split, n in (('train', 6), ('val', 30)):
        t = tzju.ZJUH36MDataset(tschema.h5_arrays(data), N_samples=4,
                                split=split, seed=0)
        j = jzju.ZJUH36MDataset(p, N_samples=4, split=split, seed=0)
        assert len(t) == len(j) == n
        _equal_dicts(t.get_meta(), j.get_meta())


@pytest.mark.parametrize('kind', KINDS)
def test_catalog_builds_each_type_like_jax(layouts, tmp_path, monkeypatch,
                                           kind):
    """get_dataset_from_catalog builds every type from the catalog's
    relative path and from an H5Arrays standing in for it (an H5Arrays
    without a path takes the catalog's), as JAX's catalog builds it."""
    _, arrays = layouts[kind]
    subject = TYPES[kind][2]
    monkeypatch.chdir(arrays.path[:-len(jcat.DATASET_CATALOG[kind][subject])])
    args = TrainConfig(N_rand=24, N_sample_images=4)
    jargs = JTrainConfig(N_rand=24, N_sample_images=4)
    want = jcat.get_dataset_from_catalog(jargs, N_PER, kind, subject)
    bare = tschema.H5Arrays(arrays)
    bare.path = None
    for source in (None, arrays, bare):
        got = tcat.get_dataset_from_catalog(args, N_PER, kind, subject,
                                            source=source)
        assert type(got) is TYPES[kind][0]
        assert type(want).__name__ == type(got).__name__
        _equal_dicts(got.get_meta(), want.get_meta())
    assert bare.path is None


@pytest.mark.parametrize('kind,multiview', [
    ('h36m', False), ('h36m', True), ('perfcap', False), ('mixamo', False)])
def test_load_refined_from_the_ports_export(layouts, tmp_path, monkeypatch,
                                            kind, multiview):
    """load_refined reads the subject's refined .tar (catalog-relative,
    legacy axes), here one the port's ckpt_compat wrote; for H36M in the
    shared-pose form (root_bones, bones (U, J-1), kp_map, kp_uidxs) of
    the reference's multiview checkpoints. Mixamo's refinement covers its
    selection only."""
    tcls, jcls, subject, _ = TYPES[kind]
    path, arrays = layouts[kind]
    monkeypatch.chdir(tmp_path)
    tar = tcls.refined_paths[subject][0]
    os.makedirs(os.path.dirname(tar), exist_ok=True)
    rng = np.random.default_rng(9)
    base = jcls(path, N_samples=N_PER, subject=subject, seed=0)
    n = len(base._idx_map) if base._idx_map is not None else len(base.kp3d)
    rows = base._idx_map if kind == 'mixamo' else slice(None)
    bones = base.bones[rows] + rng.normal(
        size=base.bones[rows].shape).astype(np.float32) * 0.05
    pose = {'pelvis': base.kp3d[rows, 0] + 0.01, 'bones': bones}
    extra = {}
    if multiview:
        kp_map, kp_uidxs = th36m.create_kp_mapping(
            *th36m.find_motion_set(arrays['img_paths']))
        pose = {'pelvis': pose['pelvis'], 'root_bones': bones[:, 0],
                'bones': bones[kp_uidxs, 1:]}
        extra = dict(kp_map=kp_map, kp_uidxs=kp_uidxs)
    tcc.export_reference_checkpoint(
        tar, {'coarse': {'pts_linears': []},
              'cutoff_dist': np.ones(24, np.float32)},
        pose_params=pose, rest_pose=arrays['rest_pose'], **extra)
    got = tcls(arrays, N_samples=N_PER, subject=subject, seed=0,
               load_refined=True, multiview=multiview)
    want = jcls(path, N_samples=N_PER, subject=subject, seed=0,
                load_refined=True, multiview=multiview)
    for name in ('kp3d', 'bones', 'skts', 'cyls'):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    assert not np.allclose(got.kp3d[rows], base.kp3d[rows], atol=1e-3)
    if multiview:
        _equal(got.kp_map, want.kp_map)
        # the .tar's shared bones come back for every view of an instant
        pp = jcc.pose_state_dict_to_params(
            torch.load(tar, weights_only=False)['poseopt_layer_state_dict'])
        _equal(pp['kp_map'], extra['kp_map'])
        _equal(pp['root_bones'], pose['root_bones'])
    assert n == len(got.kp3d[rows])


# ------------------------------------------------- train() on the new types

def _converted(root, kind, npz):
    """A converted set: the port's converter on tests/rawlayout.py's raw
    tree, at the catalog's relative path under `root`."""
    import rawlayout
    from anerf_torch.data import process_h36m, process_perfcap
    raw = os.path.join(str(root), 'raw')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('ANERF_SMPL_TABLES', npz)
        if kind == 'h36m':
            rawlayout.build_h36m_raw(raw)
            return process_h36m.process_h36m_data(raw, subject='S9')
        rawlayout.build_perfcap_raw(raw)
        return process_perfcap.process_perfcap_data(raw, img_res=(64, 64))


def _type_pair(kind, h5, base, fused):
    """JAX's train() and the port's from JAX's initial state on a
    converted set: H36M with --multiview (poses shared by the 4 views),
    MonoPerfCap on the per-item route (temporal validity)."""
    import jax.numpy as jnp

    from anerf_tpu.train import loop as jloop
    from anerf_torch.train import loop as tloop
    from test_torch_loop import _np, _seed_port, _torch_args, loop_args

    subject = TYPES[kind][2]
    extra = dict(multiview=True) if kind == 'h36m' else {}
    args = loop_args(base, h5, 'jax', fused, dataset_type=(kind,),
                     subject=(subject,), N_rand=48, N_sample_images=4,
                     **extra)

    def ds(cls, a):
        return cls(h5, N_samples=a.N_rand // a.N_sample_images,
                   subject=subject, seed=7, **extra)

    state0 = _np(jloop.setup(args, ds(TYPES[kind][1], args)).state)
    if kind == 'h36m':
        # JAX's loop builds its step without the dataset's kp_map, so the
        # shared (U, J-1) bones go to FK as per-frame bones and the trace
        # fails (ROADMAP.md Queue 3). The comparison runs JAX's train()
        # with its step given kp_map, as the port's loop gives it.
        with pytest.raises(ValueError, match='Incompatible shapes'):
            jloop.train(args, ds(TYPES[kind][1], args))
        kp_map = jnp.asarray(ds(TYPES[kind][1], args).kp_map)
        make = jloop.make_train_step_scan
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jloop, 'make_train_step_scan',
                       lambda *a, **kw: make(*a, kp_map=kp_map, **kw))
            jctx = jloop.train(args, ds(TYPES[kind][1], args))
    else:
        jctx = jloop.train(args, ds(TYPES[kind][1], args))
    targs = _torch_args(args, expname='port')
    _seed_port(os.path.join(targs.basedir, targs.expname), state0)
    tpipe.SUPER_BATCHES = tpipe.ITEM_BATCHES = 0
    tctx = tloop.train(targs, ds(TYPES[kind][0], targs), device='cpu',
                       save_images=False)
    routes = (tpipe.SUPER_BATCHES, tpipe.ITEM_BATCHES)
    return jctx, tctx, routes


@pytest.fixture(scope='module')
def converted(tmp_path_factory, smpl_tables_npz):
    return {k: _converted(tmp_path_factory.mktemp(f'conv_{k}'), k,
                          smpl_tables_npz) for k in ('h36m', 'perfcap')}


@pytest.mark.parametrize('branch', ['plain', 'fused'])
@pytest.mark.parametrize('kind', ['h36m', 'perfcap'])
def test_train_on_the_type_matches_jax(converted, tmp_path, kind, branch):
    """The tolerances of tests/test_torch_loop.py::test_train_matches_jax:
    losses and stats 1e-5 relative on the plain branch, 2e-3 on the fused
    one; final params and poses 2e-5 / 5e-3 relative to the largest
    value."""
    from jax.flatten_util import ravel_pytree

    from anerf_torch.train import state as tst
    from test_torch_loop import LOSS_KEYS, _records, _relmax

    fused = branch == 'fused'
    jctx, tctx, (sup, item) = _type_pair(kind, converted[kind], tmp_path,
                                         fused)
    # H36M's 3 dispatches from the native assembler, MonoPerfCap's from
    # per-item batches, 2 a dispatch (the loader prefetches more)
    if kind == 'h36m':
        assert sup >= 3 and item == 0
    else:
        assert sup == 0 and item >= 6
    loss_tol, param_tol = (2e-3, 5e-3) if fused else (1e-5, 2e-5)
    jrec, trec = _records(jctx.exp_dir), _records(tctx.exp_dir)
    assert [r['step'] for r in trec] == [r['step'] for r in jrec] == [2, 4, 6]
    for a, b in zip(jrec, trec):
        keys = [k for k in LOSS_KEYS if k in a]
        assert keys == [k for k in LOSS_KEYS if k in b]
        for k in keys:
            # MPJPC is in the hundreds here (SPIN-scale poses against
            # their anchors), not a float-noise value: the loss bound
            assert abs(a[k] - b[k]) <= loss_tol * max(abs(a[k]), 1e-6), \
                (a['step'], k, a[k], b[k])
    assert _relmax(ravel_pytree(jctx.state.params)[0],
                   tst.flatten_tree(tctx.state.params).numpy()) < param_tol
    jpose, tpose = jctx.state.pose_params, tctx.state.pose_params
    assert sorted(jpose) == sorted(tpose) == (
        ['bones', 'pelvis', 'root_bones'] if kind == 'h36m'
        else ['bones', 'pelvis'])
    for k in jpose:
        assert _relmax(np.asarray(jpose[k]), tpose[k].numpy()) < param_tol, k
    if kind == 'h36m':
        # 2 sequences x 2 instants shared by the 4 cameras' images
        assert tuple(tpose['bones'].shape[:2]) == (4, 23)
        assert not np.allclose(tpose['pelvis'].numpy(),
                               tctx.state.anchors['kps'][:, 0].numpy())


@pytest.mark.parametrize('shape', [(7, 3), (9, 23, 6), (64, 23, 6)])
def test_gather_rows_backward_is_autograds_on_the_cpu(shape):
    """pose_opt.gather_rows (the pose tables' gathers, a sort-and-segment
    sum backward) against autograd's own backward of indexing: the same
    bits, duplicate rows (4 views of an instant, repeated images) and
    rows no index reads included."""
    from anerf_torch.pose.pose_opt import gather_rows
    gen = torch.Generator().manual_seed(shape[0])
    table = torch.randn(*shape, generator=gen)
    idx = torch.cat([torch.randint(0, shape[0] // 2, (40,), generator=gen),
                     torch.arange(shape[0] // 2).repeat(4)])
    g = torch.randn(len(idx), *shape[1:], generator=gen)
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    gather_rows(a, idx).backward(g)
    b[idx].backward(g)
    assert torch.equal(gather_rows(table, idx), table[idx])
    assert torch.equal(a.grad, b.grad)
    assert not a.grad[shape[0] // 2:].any()
