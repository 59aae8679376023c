"""anerf_torch's offline converters (data/process_*.py, smpl_tables.py),
evaluation helpers (utils/eval_helpers.py) and DeviceProfiler
(utils/logging.py) against anerf_tpu's, on the CPU.

Each converter runs on a raw layout of tests/rawlayout.py (or the
SURREAL dump of tests/test_process_surreal.py), built twice from its
fixed seed, one copy per package, with the shared SMPL tables
(`smpl_tables_env`; both packages read ANERF_SMPL_TABLES). The two h5
files must be equal key for key: the same keys, dtypes and values, bit
for bit (the converters are the same numpy / cv2 / scipy code). The
helpers are held bit for bit on the same inputs, except where a bound is
stated.
"""
import json
import os
import pickle

import h5py
import numpy as np
import pytest

from anerf_tpu.data import process_3dhp as j3dhp
from anerf_tpu.data import process_h36m as jh36m
from anerf_tpu.data import process_mask as jmask
from anerf_tpu.data import process_mixamo as jmix
from anerf_tpu.data import process_perfcap as jperf
from anerf_tpu.data import process_spin as jspin
from anerf_tpu.data import process_surreal as jsur
from anerf_tpu.data import process_zju as jzju
from anerf_tpu.data import smpl_tables as jst
from anerf_tpu.utils import eval_helpers as jeval

from anerf_torch.data import process_3dhp as t3dhp
from anerf_torch.data import process_h36m as th36m
from anerf_torch.data import process_mask as tmask
from anerf_torch.data import process_mixamo as tmix
from anerf_torch.data import process_perfcap as tperf
from anerf_torch.data import process_spin as tspin
from anerf_torch.data import process_surreal as tsur
from anerf_torch.data import process_zju as tzju
from anerf_torch.data import smpl_tables as tst
from anerf_torch.utils import eval_helpers as teval
from anerf_torch.utils import trace
from anerf_torch.utils.logging import DeviceProfiler

import rawlayout
from test_process_surreal import make_fake_surreal_dump
from test_smpl_tables import _synth_model


def _same_h5(a, b):
    with h5py.File(a, 'r') as fa, h5py.File(b, 'r') as fb:
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k].dtype == fb[k].dtype, k
            assert fa[k].shape == fb[k].shape, k
            np.testing.assert_array_equal(fa[k][()], fb[k][()], err_msg=k)
        return sorted(fb)


def _convert(kind, root):
    """Run each package's converter on its own copy of the raw tree;
    returns the two h5 paths (port, JAX)."""
    build, run = {
        'h36m': (rawlayout.build_h36m_raw,
                 lambda m, r: m.process_h36m_data(r, subject='S9')),
        'perfcap': (rawlayout.build_perfcap_raw,
                    lambda m, r: m.process_perfcap_data(r, img_res=(64, 64))),
        'mixamo': (rawlayout.build_mixamo_raw,
                   lambda m, r: m.process_mixamo_data(r, subject='James',
                                                      n_cam=2)),
        '3dhp': (rawlayout.build_3dhp_raw,
                 lambda m, r: m.process_3dhp_data(r, 'S1')),
        'zju': (rawlayout.build_zju_raw,
                lambda m, r: m.process_zju_data(r, subject='377',
                                                training_view=(0, 2))),
    }[kind]
    mods = {'h36m': (th36m, jh36m), 'perfcap': (tperf, jperf),
            'mixamo': (tmix, jmix), '3dhp': (t3dhp, j3dhp),
            'zju': (tzju, jzju)}[kind]
    outs = []
    for mod, side in zip(mods, ('port', 'jax')):
        r = os.path.join(str(root), side)
        os.makedirs(r)
        build(r)
        outs.append(run(mod, r))
    return outs


@pytest.mark.parametrize('kind', ['h36m', 'perfcap', 'mixamo', '3dhp',
                                  'zju'])
def test_converter_writes_jaxs_h5(kind, smpl_tables_env, tmp_path):
    got, want = _convert(kind, tmp_path)
    assert os.path.relpath(got, str(tmp_path / 'port')) == \
        os.path.relpath(want, str(tmp_path / 'jax'))
    keys = _same_h5(got, want)
    assert {'imgs', 'masks', 'sampling_masks', 'kp3d', 'skts', 'cyls',
            'c2ws', 'focals', 'rest_pose'} <= set(keys)
    if kind == 'mixamo':
        np.testing.assert_array_equal(
            np.load(got.replace('processed_h5py.h5', 'selected.npy')),
            np.load(want.replace('processed_h5py.h5', 'selected.npy')))


def test_zju_test_split_converter(smpl_tables_env, tmp_path):
    got, want = [], []
    for mod, side, out in ((tzju, 'port', got), (jzju, 'jax', want)):
        r = str(tmp_path / side)
        rawlayout.build_zju_raw(r)
        # NUM_TRAIN_FRAMES['377'] is 300 and the layout has 3 frames:
        # rewind the test window's start (begin + 300) onto frame 2
        out.append(mod.process_zju_data(
            r, subject='377', split='test', training_view=(0, 2),
            begin_ith_frame=-298))
    assert got[0].endswith('377_test_h5py.h5')
    _same_h5(got[0], want[0])


def test_surreal_converter_writes_jaxs_h5(tmp_path):
    outs = []
    for mod, side in ((tsur, 'port'), (jsur, 'jax')):
        root = str(tmp_path / side / 'raw')
        os.makedirs(root)
        make_fake_surreal_dump(root)
        h5 = str(tmp_path / side / 'out_train_h5py.h5')
        data = mod.process_surreal_data(h5, root, extend_iter=1)
        outs.append((h5, data))
    _same_h5(outs[0][0], outs[1][0])
    for k, v in outs[1][1].items():
        np.testing.assert_array_equal(outs[0][1][k], v, err_msg=k)
    np.testing.assert_array_equal(
        tsur.get_img_cam_indices(12, 2, 6, 3, np.array([0, 1])),
        jsur.get_img_cam_indices(12, 2, 6, 3, np.array([0, 1])))


@pytest.fixture(scope='module')
def spin_packs(tmp_path_factory):
    d = tmp_path_factory.mktemp('spin')
    paths = ([f'S1/Seq1/imageSequence/f_{i}.png' for i in range(4)]
             + [f'S2/Seq1/imageSequence/f_{i}.png' for i in range(3)])
    h5 = os.path.join(str(d), 'pack.h5')
    pkl = os.path.join(str(d), 'pack.pkl')
    rawlayout.make_spin_pack(h5, paths, np.random.default_rng(21),
                             gt_pose3d=True)
    rawlayout.make_spin_pack(pkl, paths, np.random.default_rng(21),
                             gt_pose3d=True, as_pkl=True)
    return h5, pkl


@pytest.mark.parametrize('pack', ['h5', 'pkl'])
@pytest.mark.parametrize('subject', [None, 'S2'])
def test_spin_conversion_matches_jax(spin_packs, smpl_tables_env, pack,
                                     subject):
    path = spin_packs[0 if pack == 'h5' else 1]
    got = tspin.read_spin_data(path, img_res=64, subject_filter=subject)
    want = jspin.read_spin_data(path, img_res=64, subject_filter=subject)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    rng = np.random.default_rng(3)
    cam, bbox = rng.uniform(0.5, 1.2, (5, 3)), rng.uniform(50, 200, (5, 3))
    for nf in (None, 1000.0):
        np.testing.assert_array_equal(
            tspin.convert_crop_cam_to_orig_img_and_focal(
                cam, bbox, 320, 240, new_focal=nf),
            jspin.convert_crop_cam_to_orig_img_and_focal(
                cam, bbox, 320, 240, new_focal=nf))


def test_smpl_tables_match_jax(tmp_path, smpl_tables_env):
    model, Jx = _synth_model(3)
    pkl, reg = str(tmp_path / 'm.pkl'), str(tmp_path / 'reg.npy')
    with open(pkl, 'wb') as f:
        pickle.dump(model, f)
    np.save(reg, Jx)
    for with_reg in (None, reg):
        a = tst.make_tables_from_smpl_pkl(pkl, str(tmp_path / 't.npz'),
                                          regressor_npy=with_reg)
        b = jst.make_tables_from_smpl_pkl(pkl, str(tmp_path / 'j.npz'),
                                          regressor_npy=with_reg)
        ta, tb = tst.load_tables(a), jst.load_tables(b)
        assert sorted(ta) == sorted(tb)
        for k in tb:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    rng = np.random.default_rng(4)
    betas = rng.normal(0, 1.0, (3, 10))
    from scipy.spatial.transform import Rotation
    rots = Rotation.from_rotvec(rng.normal(0, 0.3, (3 * 24, 3))) \
        .as_matrix().reshape(3, 24, 3, 3)
    np.testing.assert_array_equal(tst.joints_from_betas(betas, ta),
                                  jst.joints_from_betas(betas, tb))
    np.testing.assert_array_equal(
        tst.regress_joints(betas, rots, ta, transl=betas[:, :3]),
        jst.regress_joints(betas, rots, tb, transl=betas[:, :3]))
    # the shared env var serves both packages
    assert tst.ENV_VAR == jst.ENV_VAR
    np.testing.assert_array_equal(tspin.rest_pose_from_betas(betas),
                                  jspin.rest_pose_from_betas(betas))
    with pytest.raises(tst.SMPLTablesMissing):
        tst.load_tables(str(tmp_path / 'absent.npz'))


def test_mask_tools_match_jax():
    rng = np.random.default_rng(6)
    masks = (rng.uniform(size=(3, 20, 24)) > 0.93).astype(np.uint8)
    for it in (0, 1, 2):
        np.testing.assert_array_equal(tmask.dilate_mask(masks[0], it),
                                      jmask.dilate_mask(masks[0], it))
        np.testing.assert_array_equal(tmask.dilate_masks(masks, it),
                                      jmask.dilate_masks(masks, it))
    np.testing.assert_array_equal(tmask.make_sampling_masks(masks[..., None]),
                                  jmask.make_sampling_masks(masks[..., None]))
    bkgd = rng.integers(0, 60, (20, 24, 3)).astype(np.uint8)
    imgs = np.repeat(bkgd[None], 3, 0).copy()
    imgs[:, 5:15, 6:16] = 220
    seg_t = tmask.get_segmenter('auto', bkgd=bkgd, min_component=4)
    seg_j = jmask.get_segmenter('auto', bkgd=bkgd, min_component=4)
    got = tmask.process_masks(imgs, seg_t)
    want = jmask.process_masks(imgs, seg_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][:, 5:15, 6:16].all()

    import torch

    def model(x):       # person logit where the image is bright
        logits = torch.zeros(1, 21, *x.shape[-2:])
        logits[0, 15] = x[0].mean(0)
        return {'out': logits}
    # the model runs on bbox crops (a background plate would not fit them)
    bboxes = np.array([[0, 0, 24, 20], [4, 3, 18, 17], [6, 5, 16, 15]])
    for bb in (None, bboxes):
        got = tmask.process_masks(imgs, tmask.get_segmenter(
            'torchvision', model=model), bboxes=bb)
        want = jmask.process_masks(imgs, jmask.get_segmenter(
            'torchvision', model=model), bboxes=bb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tmask.get_segmenter('bkgd')


def test_eval_helpers_match_jax(tmp_path, smpl_tables_env):
    rng = np.random.default_rng(7)
    rgbs = rng.uniform(size=(3, 16, 20, 3))
    gts = np.clip(rgbs + rng.normal(size=rgbs.shape) * 0.05, 0, 1)
    fgs = (rng.uniform(size=(3, 16, 20, 1)) > 0.4).astype(np.float32)
    boxes = np.array([[[2, 3], [18, 14]]] * 3)
    for kw in ({}, dict(fgs=fgs, boxes=boxes)):
        got = teval.evaluate_metric(rgbs, gts, outdir=str(tmp_path / 't'),
                                    **kw)
        want = jeval.evaluate_metric(rgbs, gts, outdir=str(tmp_path / 'j'),
                                     **kw)
        assert got == want
    for name in ('psnr', 'ssim', 'fg_psnr', 'box_ssim'):
        assert (tmp_path / 't' / f'{name}.txt').read_text() == \
            (tmp_path / 'j' / f'{name}.txt').read_text()
    p, g = rng.normal(size=(4, 24, 3)), rng.normal(size=(4, 24, 3))
    assert teval.evaluate_pose_error(p, g) == jeval.evaluate_pose_error(p, g)

    tables = tst.load_tables()
    betas = rng.normal(0, 1.0, (1, 10))
    bones = rng.normal(0, 0.3, (3, 24, 3))
    gt = rng.normal(0, 300.0, (3, 17, 3))
    got = teval.evaluate_pampjpe_from_smpl_params(gt, betas, bones,
                                                  tables=tables, ret_kp=True)
    want = jeval.evaluate_pampjpe_from_smpl_params(gt, betas, bones,
                                                   ret_kp=True)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])

    log = tmp_path / 'metrics.jsonl'
    log.write_text(json.dumps({'step': 1, 'psnr': 2.0}) + '\n\n'
                   + json.dumps({'step': 2}) + '\n')
    assert teval.read_metrics_jsonl(str(log)) == \
        jeval.read_metrics_jsonl(str(log)) == [{'step': 1, 'psnr': 2.0},
                                               {'step': 2}]


def test_device_profiler_writes_a_trace_over_its_window(tmp_path):
    import torch
    prof = DeviceProfiler(str(tmp_path), start_step=2, num_steps=2)
    active = []
    for step in range(1, 7):       # the hooks at the top of each step
        prof.maybe_stop(step)
        prof.maybe_start(step)
        active.append(prof.active)
        with trace.span('anerf.train.step', 64):
            torch.randn(64, 64) @ torch.randn(64, 64)
    # the window is steps 2 and 3
    assert active == [False, True, True, False, False, False]
    assert prof.trace_path == str(tmp_path / 'profile' / 'trace_2_4.json')
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
    assert any('mm' in e.key for e in prof.last.key_averages())
    # the spans were on for the window alone, summed beside the trace
    assert prof.spans_path == str(tmp_path / 'profile' / 'spans_2_4.json')
    with open(prof.spans_path) as f:
        spans = json.load(f)
    assert set(spans) == {'anerf.train.step'}
    assert spans['anerf.train.step']['count'] == 2
    assert spans['anerf.train.step']['n'] == 128
    assert spans['anerf.train.step']['total_ms'] > 0
    assert trace.span('anerf.train.step') is trace.span('anerf.x')
    assert trace.take() == []
    # a window that never opens writes nothing
    idle = DeviceProfiler(str(tmp_path / 'idle'), start_step=-1)
    for step in range(3):
        idle.maybe_start(step)
        idle.maybe_stop(step)
    assert idle.last is None and not os.path.exists(idle.dir)
