"""A short run of each cell on the card: one JSON line with the
contract's keys, `correct` true, no JAX loaded (`gpu`; skipped here)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize('cell', ['surreal.train', 'surreal_single.render'])
@pytest.mark.parametrize('trace', [0, 1])
def test_a_short_run(card, cell, trace):
    p = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         '4000000001', '--seconds', '3', '--trace', str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == 'checks'
    assert {'correct', 'attempted', 'failed', 'metrics', 'device'} <= set(out)
    assert out['correct'] and out['device']['platform'] == 'gpu'
    if trace:
        assert 0 < out['device']['busy_s'] <= out['device']['window_s']
    else:
        assert 'setup_s' in out['metrics']
