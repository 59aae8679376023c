"""No run loads JAX or the JAX package, and the reference's process
loads nothing of the program. Module names are compared by their
top-level name, whole: `anerf_torch` begins with `anerf_` and is not
`anerf_tpu`."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

RUN_TINY = '''
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark import harness
out = harness.run_cell(tiny_cell({cell!r}), 7, 0.5, False, 'cpu')
print(json.dumps({{'correct': out['correct'],
                  'modules': sorted({{m.split('.')[0]
                                      for m in sys.modules}})}}))
'''

RUN_REFERENCE = '''
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark import scene
from benchmark.drivers.train import model_of
from benchmark.reference import anerf as ref
cfg = json.load(open({config!r}))
cfg['train_config'].update(netdepth=2, N_samples=8, N_importance=4)
sk = scene.skeleton(4)
nets = scene.weights(cfg, 4, 1, 'cpu')
c2w = scene.request_camera(sk, 0, 0.5, [0.0, 0.2, 2.5])
img = ref.render_image(nets, model_of(cfg), sk['kp3d'][0], sk['skts'][0], 0,
                       c2w, 24, 24, 28.8, 128, torch.device('cpu'))
print(json.dumps({{'finite': bool(np.isfinite(img['rgbs']).all()),
                  'modules': sorted({{m.split('.')[0]
                                      for m in sys.modules}})}}))
'''


def _last_json(code: str) -> dict:
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', ['surreal.train', 'surreal_single.render'])
def test_a_run_loads_no_jax(cell):
    out = _last_json(RUN_TINY.format(root=str(ROOT),
                                     tests=str(ROOT / 'benchmark' / 'tests'),
                                     cell=cell))
    assert out['correct']
    assert 'anerf_torch' in out['modules']
    assert not {'jax', 'jaxlib', 'flax', 'anerf_tpu'} & set(out['modules'])


def test_the_reference_loads_nothing_of_the_program():
    out = _last_json(RUN_REFERENCE.format(
        root=str(ROOT),
        config=str(ROOT / 'benchmark' / 'configs' / 'surreal.json')))
    assert out['finite']
    assert not {'anerf_torch', 'jax', 'jaxlib', 'flax',
                'anerf_tpu'} & set(out['modules'])


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, 'anerf_tpu_like', sys)
    assert 'anerf_tpu_like' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.xla', sys)
    assert 'jaxlib.xla' in harness.forbidden_modules()
