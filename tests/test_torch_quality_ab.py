"""anerf_torch/tools/quality_ab.py and qab_table.py against bench.py's
quality A/B and tools/qab_table.py, on the CPU.

The cases of tests/test_bench_quality_ab.py run against the port's tool
with train / run_validation stubbed. Parity with JAX on the same inputs:
the variants, keys and the protocol's TrainConfig fields equal
bench.py's; the perturbed fixture equal to bench's (bones, kp3d, skts bit
for bit: both are numpy; cyls to 1e-7 and init_mpjpe_mm to 1e-6 mm,
float32 rounding of the same numpy expressions); the refined MPJPE /
PA-MPJPE on JAX's pose parameters within 1e-3 mm unrounded (FK in torch
and in XLA, f32); qab_table's text equal to tools/qab_table.py's. One
real cell trains through the port's train() at small widths.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from anerf_torch.tools import qab_table as tqt
from anerf_torch.tools import quality_ab as tq

ROOT = Path(__file__).resolve().parents[1]
#: a perturbed fixture's cylinders and init MPJPE against bench's: the
#: same numpy expressions in both packages, so float32 rounding at most
CYL_ATOL = 1e-7
INIT_MM_ATOL = 1e-6
#: refined MPJPE / PA-MPJPE, unrounded: FK in torch against FK in XLA,
#: both f32 (about 1e-4 mm apart at the fixture's scale)
POSE_MM_ATOL = 1e-3
#: a test-sized protocol for the real cell (TrainConfig fields)
SMALL = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
             multires=3, multires_views=2, N_samples=8, N_importance=4,
             N_rand=64, N_sample_images=4, chunk=1024, scan_unroll=2,
             i_print=2)


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    """The port's tool with train / run_validation stubbed; its fixtures
    and state in tmp_path."""
    import tempfile

    from anerf_torch.train import loop

    calls = []

    def fake_train(args, ds, n_iters, **kw):
        calls.append(args.expname)
        return {'expname': args.expname}

    def fake_validation(ctx, steps, max_images=3):
        return {'psnr': 20.0 + len(calls), 'fg_psnr': 21.0, 'fg_ssim': 0.9}

    monkeypatch.setattr(loop, 'train', fake_train)
    monkeypatch.setattr(loop, 'run_validation', fake_validation)
    monkeypatch.setattr(tempfile, 'gettempdir', lambda: str(tmp_path))
    return calls


def _verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------- test_bench_quality_ab.py's cases

def test_quality_ab_resumes_finished_cells(stubbed, tmp_path, capsys):
    calls = stubbed
    state = str(tmp_path / 'state.jsonl')

    tq.quality_ab(steps=4, styles=['blobs'], seeds=[0, 1],
                  cull_ratio=0.125, state_path=state, device='cpu')
    assert len(calls) == 4                     # 2 seeds x 2 configs
    assert len(open(state).read().splitlines()) == 4
    first = _verdict(capsys)

    calls.clear()
    tq.quality_ab(steps=4, styles=['blobs'], seeds=[0, 1],
                  cull_ratio=0.125, state_path=state, device='cpu')
    assert calls == []
    verdict = _verdict(capsys)
    assert verdict == first
    assert verdict['metric'] == 'quality_ab_delta_psnr'
    assert len(verdict['rows']) == 4
    assert verdict['deltas']['culled'].keys() >= {'median', 'std', 'n'}
    assert verdict['deltas']['culled']['n'] == 2

    # a different protocol (a deeper cull) does not reuse the state
    calls.clear()
    tq.quality_ab(steps=4, styles=['blobs'], seeds=[0],
                  cull_ratio=0.0625, state_path=state, device='cpu')
    assert len(calls) == 2


def test_quality_ab_partial_state_resumes_midway(stubbed, tmp_path):
    calls = stubbed
    state = str(tmp_path / 'state.jsonl')
    tq.quality_ab(steps=4, styles=['blobs'], seeds=[0], cull_ratio=0.125,
                  state_path=state, device='cpu')
    assert len(calls) == 2
    lines = open(state).read().splitlines()
    with open(state, 'w') as f:
        f.write(lines[0] + '\n')
    calls.clear()
    tq.quality_ab(steps=4, styles=['blobs'], seeds=[0], cull_ratio=0.125,
                  state_path=state, device='cpu')
    assert len(calls) == 1


def test_quality_ab_edited_variant_invalidates_state(stubbed, tmp_path,
                                                     monkeypatch):
    calls = stubbed
    state = str(tmp_path / 'state.jsonl')
    kw = dict(steps=4, styles=['blobs'], seeds=[0], cull_ratio=0.125,
              state_path=state, variants=('control', 'fast'), device='cpu')
    tq.quality_ab(**kw)
    assert len(calls) == 2
    calls.clear()
    monkeypatch.setitem(tq.AB_VARIANTS, 'fast',
                        lambda cull: dict(fast_grads=True, sr_grads=True))
    tq.quality_ab(**kw)
    # the port's experiments take a prefix of their own
    assert calls == ['torch_qab_blobs_0_fast']


def test_parse_style_resolution_suffix():
    import bench
    for style, want in (('limbs', ('limbs', 64)), ('clutter', ('clutter', 96)),
                        ('limbs@128', ('limbs', 128))):
        assert tq._parse_style(style) == want == bench._parse_style(style)


def test_perturbed_fixture_helper(tmp_path):
    """The refine cells' fixture copy: GT stays, poses move, cyls
    follow; a second call reuses the file."""
    from anerf_torch.data.fixtures import make_synthetic_h5

    src = str(tmp_path / 'src.h5')
    make_synthetic_h5(src, n_kps=2, n_cams=1, H=16, W=16)
    dst = str(tmp_path / 'pert.h5')
    gt_kp, init_mm = tq._ensure_perturbed_h5(src, dst, seed=0)
    with h5py.File(src) as fs, h5py.File(dst) as fd:
        np.testing.assert_array_equal(fd['gt_kp3d'][:], fs['gt_kp3d'][:])
        for k in ('kp3d', 'skts', 'cyls'):
            assert not np.allclose(fd[k][:], fs[k][:]), k
        np.testing.assert_array_equal(fd['imgs'][:], fs['imgs'][:])
    assert init_mm > 5.0        # 5 deg + 20 mm noise is tens of mm
    assert tq._ensure_perturbed_h5(src, dst, seed=0)[1] == init_mm


def test_quality_ab_real_h5_style(stubbed, tmp_path):
    calls = stubbed
    from anerf_torch.data.fixtures import make_synthetic_h5

    real = tmp_path / 'scene' / 'real_train_h5py.h5'
    os.makedirs(real.parent)
    make_synthetic_h5(str(real), n_kps=4, n_cams=2, H=32, W=32)
    state = str(tmp_path / 'state.jsonl')
    tq.quality_ab(steps=4, styles=[f'h5:{real}'], seeds=[0],
                  cull_ratio=0.125, state_path=state, device='cpu')
    assert len(calls) == 2
    rows = [json.loads(line) for line in open(state)]
    assert all(r['style'] == f'h5:{real}' for r in rows)
    with pytest.raises(FileNotFoundError):
        tq.quality_ab(steps=4, styles=['h5:/nonexistent.h5'], seeds=[0],
                      cull_ratio=0.125, state_path=state, device='cpu')


# ---------------------------------------------------- parity with bench

def test_variants_and_signatures_match_bench():
    import bench
    assert set(tq.AB_VARIANTS) == set(bench.AB_VARIANTS)
    assert tq.AB_CONTROL == bench.AB_CONTROL
    assert tq.AB_PERTURBED == bench.AB_PERTURBED
    assert tq._POSE_RECIPE == bench._POSE_RECIPE
    for name in bench.AB_VARIANTS:
        for cull in (0.125, 0.0625):
            over = tq.AB_VARIANTS[name](cull)
            assert over == bench.AB_VARIANTS[name](cull)
            assert tq._overrides(name, cull, False) == over
            assert tq._variant_sig(over) == bench._variant_sig(over)


def _jax_stubbed(monkeypatch, tmp_path):
    """bench.quality_ab with JAX's train / run_validation stubbed: the
    TrainConfig of each cell."""
    import tempfile

    import anerf_tpu.train.loop as jloop

    seen = []

    def fake_train(args, ds, n_iters, **kw):
        seen.append(args)
        return None

    monkeypatch.setattr(jloop, 'train', fake_train)
    monkeypatch.setattr(jloop, 'run_validation',
                        lambda ctx, steps, max_images=3: {
                            'psnr': 20.0, 'fg_psnr': 21.0, 'fg_ssim': 0.9})
    monkeypatch.setattr(tempfile, 'gettempdir', lambda: str(tmp_path))
    return seen


def test_cells_match_bench(tmp_path, monkeypatch, capsys):
    """The plain branch's cells are bench.py's: the same TrainConfig
    fields (but the experiment's name and directory), keys and row
    fields. Refine cells stubbed alike (no pose metrics: no context)."""
    import bench
    from anerf_torch.train import loop

    jseen = _jax_stubbed(monkeypatch, tmp_path)
    variants = ('control', 'culled', 'fast', 'sr', 'sr_culled', 'fastv2')
    bench.quality_ab(4, ['blobs@16'], [0, 1], 0.125,
                     state_path=str(tmp_path / 'j.jsonl'),
                     variants=variants)
    jv = _verdict(capsys)
    tseen = []
    monkeypatch.setattr(loop, 'train',
                        lambda args, ds, n_iters, **kw: tseen.append(args))
    monkeypatch.setattr(loop, 'run_validation',
                        lambda ctx, steps, max_images=3: {
                            'psnr': 20.0, 'fg_psnr': 21.0, 'fg_ssim': 0.9})
    tq.quality_ab(4, ['blobs@16'], [0, 1], 0.125,
                  state_path=str(tmp_path / 't.jsonl'), variants=variants,
                  device='cpu')
    tv = _verdict(capsys)
    assert len(tseen) == len(jseen) == 12
    for t, j in zip(tseen, jseen):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert t.expname == 'torch_' + j.expname
        for k in ('expname', 'basedir', 'subject'):
            td.pop(k), jd.pop(k)
        shared = set(td) & set(jd)
        assert {k: td[k] for k in shared} == {k: jd[k] for k in shared}
        assert set(dataclasses.asdict(j)) <= set(dataclasses.asdict(t))
    for tr, jr in zip(tv['rows'], jv['rows']):
        assert tr.keys() == jr.keys()
        assert tr['key'] == jr['key']
    assert tv['deltas'] == jv['deltas'] and tv['unit'] == jv['unit']


@pytest.mark.parametrize('seed', [0, 3])
def test_perturbed_copy_matches_bench(tmp_path, seed):
    import bench
    from anerf_tpu.data.fixtures import make_synthetic_h5

    src = str(tmp_path / 'src.h5')
    make_synthetic_h5(src, n_kps=3, n_cams=1, H=16, W=16)
    jgt, jinit = bench._ensure_perturbed_h5(src, str(tmp_path / 'j.h5'),
                                            seed)
    tgt, tinit = tq._ensure_perturbed_h5(src, str(tmp_path / 't.h5'), seed)
    np.testing.assert_array_equal(tgt, jgt)
    assert abs(tinit - jinit) <= INIT_MM_ATOL
    with h5py.File(tmp_path / 'j.h5') as fj, \
            h5py.File(tmp_path / 't.h5') as ft:
        assert set(ft) == set(fj)
        for k in ('bones', 'kp3d', 'skts'):
            np.testing.assert_array_equal(ft[k][:], fj[k][:], err_msg=k)
        np.testing.assert_allclose(ft['cyls'][:], fj['cyls'][:], rtol=0,
                                   atol=CYL_ATOL)
        for k in set(fj) - {'bones', 'kp3d', 'skts', 'cyls'}:
            np.testing.assert_array_equal(ft[k][()], fj[k][()], err_msg=k)


def test_refined_pose_metrics_match_jax(tmp_path):
    """bench._refined_pose_metrics' numbers, unrounded, from the same
    pose parameters: JAX's rot6d pose tree (moved off its init, as
    training moves it) carried across by convert.params_from_numpy."""
    import types

    import jax
    import jax.numpy as jnp
    import torch

    from anerf_tpu.pose import pose_opt as jpo
    from anerf_tpu.utils import metrics as jmet
    from anerf_torch.convert import params_from_numpy
    from anerf_torch.data.fixtures import synthetic_data
    from anerf_torch.pose import pose_opt as tpo

    data = synthetic_data(n_kps=4, n_cams=1, H=16, W=16)
    pert = tq._perturbed(data['bones'], data['kp3d'], data['rest_pose'],
                         0, 0.001)
    gt = data['gt_kp3d']
    jcfg = jpo.PoseOptConfig(use_rot6d=True)
    jparams = jpo.init_pose_params(pert['kp3d'], pert['bones'], jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape, scale=1e-2),
                                  x.dtype), jparams)
    rest = np.asarray(data['rest_pose'], np.float32)
    kps = np.asarray(jpo.fk_lookup(jparams, jnp.arange(gt.shape[0]),
                                   jnp.asarray(rest), jcfg)[0])
    want = {'mpjpe_mm': jmet.mpjpe(kps, gt) / 0.001,
            'pa_mpjpe_mm': jmet.pa_mpjpe(kps, gt) / 0.001}
    ctx = types.SimpleNamespace(
        state=types.SimpleNamespace(pose_params=params_from_numpy(
            jax.tree.map(np.asarray, jparams), device='cpu')),
        rest_pose=torch.as_tensor(rest[None]),
        pose_cfg=tpo.PoseOptConfig(use_rot6d=True))
    got = tq._refined_pose_metrics(ctx, gt, digits=None)
    for k in want:
        assert abs(got[k] - want[k]) <= POSE_MM_ATOL, (k, got[k], want[k])
    assert got['mpjpe_mm'] > 1.0
    assert tq._refined_pose_metrics(ctx, gt) == {
        k: round(v, 1) for k, v in got.items()}


@pytest.mark.parametrize('name', ['quality_ab_round5.jsonl',
                                  'quality_ab_round3.jsonl'])
def test_qab_table_matches_jax(name, capsys):
    path = f'artifacts/{name}'
    want = subprocess.run([sys.executable, 'tools/qab_table.py', path],
                          cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert tqt.main(path) == 0
    finally:
        os.chdir(cwd)
    assert capsys.readouterr().out == want


# ------------------------------------------------------- the port's own

def test_no_h5py_route_gives_the_files_arrays(tmp_path, monkeypatch):
    """Where h5py is absent the fixture and its perturbed copy are
    H5Arrays, equal to the files the h5 route writes, with the same
    init_mpjpe_mm."""
    from anerf_torch.data.fixtures import have_h5py

    d, h5 = tq._style_h5('blobs@16', str(tmp_path / 'files'))
    gt, init = tq._ensure_perturbed_h5(h5, os.path.join(d, 'p.h5'), 2)
    with h5py.File(h5) as f:
        fixture = {k: f[k][()] for k in f}
    with h5py.File(os.path.join(d, 'p.h5')) as f:
        perturbed = {k: f[k][()] for k in f}

    monkeypatch.setitem(sys.modules, 'h5py', None)
    assert not have_h5py()
    d2, arrays = tq._style_h5('blobs@16', str(tmp_path / 'arrays'))
    assert isinstance(arrays, dict) and arrays.path.endswith(
        'syn_train_h5py.h5')
    assert not os.path.exists(arrays.path)
    pert, gt2, init2 = tq._perturbed_arrays(arrays, 2)
    for got, want in ((arrays, fixture), (pert, perturbed)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(gt2, gt)
    assert init2 == init
    with pytest.raises(ImportError):
        tq._style_h5(f'h5:{h5}', str(tmp_path))


def test_fused_cells_have_their_own_keys(stubbed, tmp_path, capsys,
                                        monkeypatch):
    """--fused_kernel: every variant gets fused_kernel=True, so its
    digest and key differ from the plain cell's; rows read
    '<variant>+fused' and pair within their branch."""
    calls = stubbed
    monkeypatch.setattr(tq, '_refined_pose_metrics', lambda ctx, gt: {
        'mpjpe_mm': 1.0, 'pa_mpjpe_mm': 1.0})
    state = str(tmp_path / 'state.jsonl')
    variants = ('control', 'culled', 'refine', 'refine_culled')
    tq.quality_ab(4, ['blobs@16'], [0], 0.125, state_path=state,
                  variants=variants, device='cpu')
    plain = _verdict(capsys)
    calls.clear()
    tq.quality_ab(4, ['blobs@16'], [0], 0.125, state_path=state,
                  variants=variants, device='cpu', fused_kernel=True)
    fused = _verdict(capsys)
    assert len(calls) == 4                     # nothing resumed
    assert calls[0] == 'torch_qab_blobs_16_0_control_fused'
    for p, f in zip(plain['rows'], fused['rows']):
        assert f['config'] == p['config'] + '+fused'
        assert f['key'][5] != p['key'][5]
        over = dict(tq.AB_VARIANTS[p['config']](0.125), fused_kernel=True)
        assert f['key'][5] == tq._variant_sig(over)
    assert fused['deltas']['culled+fused']['vs'] == 'control+fused'
    assert fused['deltas']['refine_culled+fused']['vs'] == 'refine+fused'
    assert set(fused['refine']) == {'refine+fused', 'refine_culled+fused'}
    assert fused['value'] == fused['deltas']['culled+fused']['median']
    # a fixed field beyond what is logged changes the key; i_print not
    calls.clear()
    tq.quality_ab(4, ['blobs@16'], [0], 0.125, state_path=state,
                  variants=('control',), device='cpu',
                  fixed={'i_print': 5})
    assert calls == []
    tq.quality_ab(4, ['blobs@16'], [0], 0.125, state_path=state,
                  variants=('control',), device='cpu',
                  fixed={'netwidth': 32})
    assert len(calls) == 1


def _rows(tmp_path, rows):
    p = tmp_path / 'rows.jsonl'
    p.write_text(''.join(json.dumps(r) + '\n' for r in rows))
    return str(p)


def test_qab_table_fused_rows(tmp_path, capsys):
    """+fused rows get their own table, pair within their branch, and a
    fused - plain table appears only where both branches ran."""
    rows = []
    for seed in (0, 1):
        for cfg, psnr in (('control', 20.0), ('culled', 21.0),
                          ('control+fused', 20.5), ('culled+fused', 21.25)):
            rows.append({'style': 'blobs', 'seed': seed, 'config': cfg,
                         'psnr': psnr + seed, 'key': ['blobs', seed, cfg]})
    assert tqt.main(_rows(tmp_path, rows)) == 0
    out = capsys.readouterr().out
    assert '| culled+fused − control+fused | +0.75 |' in out
    assert '| culled − control | +1.00 |' in out
    assert 'Fused branch' in out
    assert '| control+fused − control | +0.50 | +0.50 | 0.00 | 2 |' in out
    assert '| culled+fused − culled | +0.25 |' in out

    fused_only = [r for r in rows if r['config'].endswith('+fused')]
    assert tqt.main(_rows(tmp_path, fused_only)) == 0
    out = capsys.readouterr().out
    assert 'Fused − plain' not in out and 'Fused branch' not in out
    assert '| culled+fused − control+fused | +0.75 |' in out


def test_one_real_cell_on_the_cpu(tmp_path, monkeypatch):
    """One refine cell through the port's train() at small widths, 4
    steps: a finite row with its pose metrics, the losses logged. Without
    tensorboard, as on the card (its import is most of the time)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    v = tq.quality_ab(4, ['blobs@16'], [0], 0.125,
                      state_path=str(tmp_path / 's.jsonl'),
                      variants=('refine',), device='cpu',
                      workdir=str(tmp_path), fixed=SMALL)
    row, = v['rows']
    assert row['config'] == 'refine'
    for k in ('psnr', 'fg_psnr', 'fg_ssim', 'rays_per_s', 'mpjpe_mm',
              'pa_mpjpe_mm'):
        assert np.isfinite(row[k]), (k, row)
    assert len(row['key']) == 7                # the small protocol's digest
    assert row['init_mpjpe_mm'] > 5.0
    recs = [json.loads(line) for line in open(
        tmp_path / 'torch_qab_blobs_16' / 'torch_qab_blobs_16_0_refine'
        / 'metrics.jsonl')]
    assert [r['step'] for r in recs] == [2, 4]
    assert all(np.isfinite(r['total_loss']) for r in recs)


def test_cli_needs_a_gpu_unless_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tq.main(['--ab_steps', '1'])


def test_cli_on_the_cpu(tmp_path, stubbed, capsys):
    tq.main(['--device', 'cpu', '--ab_steps', '4', '--ab_styles', 'blobs@16',
             '--ab_seeds', '0', '--ab_variants', 'control', 'culled',
             '--ab_state', str(tmp_path / 's.jsonl'), '--ab_dir',
             str(tmp_path), '--fused_kernel'])
    out = capsys.readouterr().out.splitlines()
    assert not any(line.startswith('card') for line in out)  # cuda only
    verdict = json.loads(out[-1])
    assert [r['config'] for r in verdict['rows']] == ['control+fused',
                                                      'culled+fused']
    assert os.path.isdir(tmp_path / 'torch_qab_blobs_16')


# ------------------------------------------------------- card settings

@pytest.mark.parametrize('device', ['cuda', 'cuda:0', 'cpu'])
def test_resolve_device_applies_the_card_settings(device, monkeypatch):
    """Every run on the card resolves its device through
    anerf_torch.resolve_device (the entry points, their ranks, the tools,
    chip_smoke.py), which sets the card's numerics there; a CPU device
    leaves the flags as they are."""
    import torch

    from anerf_torch import resolve_device
    m = torch.backends.cuda.matmul
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(m, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(m, 'allow_bf16_reduced_precision_reduction', True)
    assert resolve_device(device) == torch.device(device)
    on = torch.device(device).type != 'cuda'
    assert (m.allow_tf32, torch.backends.cudnn.allow_tf32,
            m.allow_bf16_reduced_precision_reduction) == (on, on, on)
    src = (ROOT / 'chip_smoke.py').read_text()
    assert "resolve_device('cuda')" in src


def test_card_settings_turn_off_reduced_precision():
    import torch

    from anerf_torch.utils.device import card_settings
    m = torch.backends.cuda.matmul
    before = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
              m.allow_bf16_reduced_precision_reduction)
    try:
        m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        m.allow_bf16_reduced_precision_reduction = True
        assert card_settings() == {'tf32_matmul': False, 'tf32_cudnn': False,
                                   'bf16_reduced_precision_reduction': False}
        assert not (m.allow_tf32 or torch.backends.cudnn.allow_tf32
                    or m.allow_bf16_reduced_precision_reduction)
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = before
