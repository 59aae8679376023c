"""The harness on the CPU at a tiny size: BENCHMARK.json keeps to the
contract's shape, a cell and a metric are added by files and entries
alone, a run without a card or without the program prints no result,
and each fault a cell can have turns `correct` false."""
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from conftest import ROOT, tiny_cell

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_benchmark_json_keeps_to_its_shape():
    spec = harness.load_json(ROOT / 'BENCHMARK.json')
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert spec['paths'] == ['benchmark']
    assert 1 <= spec['run_seconds'] <= 51
    assert (ROOT / spec['command'][1]).is_file()
    e2e = {m['name']: m for m in spec['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in spec['end_to_end'] + spec['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in spec['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    used = set()
    for w in spec['workloads']:
        assert NAME.match(w['name']) and w['chips'] in (1, 4)
        assert len(w['why']) <= 200
        used.add(w['config'])
        cell = harness.load_cell(spec, w['name'])
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer
        assert set(cell.limits)
        assert (harness.HERE / 'drivers'
                / f'{cell.traffic["kind"]}.py').is_file()
    for m in spec['per_layer']:
        assert m['moves'] in e2e
        assert (harness.HERE / 'metrics' / f'{m["name"]}.py').is_file()
    for c in spec['configs']:
        assert c['name'] in used
        assert (ROOT / c['file']).is_file()
        assert harness.load_json(ROOT / c['file'])['reduced'] == c['reduced']


def test_a_cell_and_a_metric_added_by_files_and_entries(tmp_path):
    base = tmp_path / 'benchmark'
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns('__pycache__'))
    spec = harness.load_json(ROOT / 'BENCHMARK.json')
    spec['workloads'].append({'name': 'surreal.train_b', 'config': 'surreal',
                              'traffic': 'train_steps', 'chips': 1,
                              'why': 'a copy of surreal.train'})
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'surreal.train' in m.get('workloads', []):
            m['workloads'].append('surreal.train_b')
    spec['per_layer'].append({
        'name': 'steps_traced.train', 'unit': 'steps', 'better': 'higher',
        'source': 'program_counter', 'layer': 'train step',
        'moves': 'train_rays_per_s', 'workloads': ['surreal.train_b']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    (base / 'metrics' / 'steps_traced.train.py').write_text(
        'def read(ctx):\n    return ctx.get("steps")\n')
    shutil.copy(base / 'limits' / 'surreal.train.json',
                base / 'limits' / 'surreal.train_b.json')
    out = harness.run_cell(tiny_cell('surreal.train_b', base), 11, 0.5,
                           True, 'cpu', base=base)
    assert out['metrics']['steps_traced.train']['value'] == 3
    assert 'idle_share.train' in out['metrics']
    assert out['correct']


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'surreal.train',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ''


def unchanged(step):
    """A step that returns its state unchanged."""
    def f(state, batch, gen):
        step(state, batch, gen)
        _, out = step(state, batch, gen)
        return state, out
    return f


def stale_after_first(step):
    """Every dispatch after the first returns the state it was given:
    state that goes stale across dispatches."""
    calls = [0]

    def f(state, batch, gen):
        calls[0] += 1
        new, out = step(state, batch, gen)
        return (new if calls[0] == 1 else state), out
    return f


def half_batch(step):
    """Half of every image's rays left out; the mean is over the rest."""
    import torch

    def f(state, batch, gen):
        pi = batch['pose_idx'][0]
        R, ni = pi.shape[0], int(pi.max()) + 1
        per = R // ni
        keep = torch.cat([torch.arange(i * per, i * per + per // 2)
                          for i in range(ni)]).to(pi.device)
        cut = {k: (v.index_select(1, keep) if k in (
            'rays', 'target_s', 'fgs', 'bgs', 'cam_idxs', 'pose_idx')
            else v) for k, v in batch.items()}
        return step(state, cut, gen)
    return f


def altered(render_path):
    """One pixel of every answer altered where it is produced."""
    def f(*a, **kw):
        out = render_path(*a, **kw)
        (x, y), _ = out['bboxes'][0]
        out['rgbs'] = out['rgbs'].copy()
        out['rgbs'][0, y, x] = 1.0 - out['rgbs'][0, y, x]
        out['rgbs'][0, y, x] += 0.5 * np.sign(out['rgbs'][0, y, x] - 0.5)
        return out
    return f


@pytest.mark.parametrize('cell, kw', [
    ('surreal.train', {}),
    ('surreal_single.render', {}),
])
def test_sound_runs_are_correct(cell, kw):
    assert harness.run_cell(tiny_cell(cell), 13, 0.5, False, 'cpu',
                            **kw)['correct']


@pytest.mark.parametrize('cell, kw', [
    ('surreal.train', {'step_wrapper': unchanged}),
    ('surreal.train', {'step_wrapper': stale_after_first}),
    ('surreal.train', {'step_wrapper': half_batch}),
    ('surreal_single.render', {'render_wrapper': altered}),
])
def test_each_fault_turns_correct_false(cell, kw):
    assert not harness.run_cell(tiny_cell(cell), 13, 0.5, False, 'cpu',
                                **kw)['correct']


def test_one_layers_gradient_off_by_a_factor_turns_correct_false(
        monkeypatch):
    """One weight matrix's gradient x 1.5 as the nerf Adam gets it: Adam's
    steps hardly move, the median leaf not at all; the larger leaves'
    worst gap sees it."""
    import torch
    from benchmark import scene
    from benchmark.drivers import train
    from benchmark.reference import anerf as ref
    cell = tiny_cell('surreal.train')
    items = ref.tree_items(scene.weights(cell.config, 8, 13, 'cpu'))
    sizes = [t.numel() for _, t in items]
    i = [p for p, _ in items].index('coarse/pts_linears/1/w')
    a = sum(sizes[:i])
    b = a + sizes[i]
    record = train.recording_adam

    def scaled(base_cls, first, tree, schedule):
        adam = record(base_cls, first, tree, schedule)
        if tree == 'nerf':
            class Scaled(type(adam)):
                def update(self, g, state):
                    g = g.clone()
                    g[a:b] *= 1.5
                    return super().update(g, state)
            adam.__class__ = Scaled
        return adam
    monkeypatch.setattr(train, 'recording_adam', scaled)
    out = harness.run_cell(cell, 13, 0.5, False, 'cpu')
    assert not out['correct']
    assert out['checks']['grad_gap_large']['value'] > 0.3
    assert out['checks']['grad_gap_median']['value'] < 2e-2
