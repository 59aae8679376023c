"""The K2 A/B tool (anerf_torch/tools/k2_ab.py) on the CPU, against a
second import of this tree's own package: the other copy loads as a
module of its own, the outputs are bit-equal, and the JSON line has the
tool's keys, K1's forward rows included. On the CPU both copies run the
plain versions, so the MLP backward distances are 0. This file imports
neither JAX nor the JAX package."""
import json
from pathlib import Path

import pytest

from anerf_torch.kernels import fused_render as fr
from anerf_torch.tools import k2_ab

ROOT = str(Path(__file__).resolve().parents[1])
ROW_KEYS = {'S', 'bit_equal', 'outputs_bit_equal', 'ms', 'other_ms',
            'turns', 'fro', 'other_fro'}
K1_ROW_KEYS = {'S', 'bit_equal', 'ms', 'other_ms', 'turns'}


def test_load_other_is_a_separate_module():
    ofr = k2_ab.load_other(ROOT)
    assert ofr is not fr and ofr.__name__.startswith('anerf_torch_other')
    assert ofr.fused_bwd is not fr.fused_bwd


@pytest.mark.parametrize('flags', [(), ('--bwd_bf16',)])
def test_k2_ab_rows(capsys, flags):
    assert k2_ab.main(['--other', ROOT, '--device', 'cpu', '--rays', '2',
                       '--reps', '1', '--shapes', '8', '5', *flags]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['metric'] == 'k2_ab' and rec['device'] == 'cpu'
    assert rec['bwd_f32'] is (not flags)
    assert [r['S'] for r in rec['rows']] == [8, 5]
    for r in rec['rows']:
        assert set(r) == ROW_KEYS and r['bit_equal'] is True
        assert r['outputs_bit_equal'] == [True] * 4
        assert len(r['turns']) == 4 and r['ms'] > 0
        if flags:
            assert r['fro'] == r['other_fro'] == 0.0
        else:
            assert r['fro'] is None and r['other_fro'] is None


@pytest.mark.parametrize('flags', [(), ('--bwd_bf16',)])
def test_k2_ab_k1_rows(capsys, flags):
    """K1's forward, one more row kind: per S, this copy's K1 against the
    other's on the same points, bit-equal, timed in turns."""
    assert k2_ab.main(['--other', ROOT, '--device', 'cpu', '--rays', '2',
                       '--reps', '1', '--shapes', '8', '5', *flags]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert [r['S'] for r in rec['k1_rows']] == [8, 5]
    for r in rec['k1_rows']:
        assert set(r) == K1_ROW_KEYS and r['bit_equal'] is True
        assert len(r['turns']) == 4 and r['ms'] > 0 and r['other_ms'] > 0
    assert sum("'kernel': 'K1'" in line for line in out) == 2


def test_k2_ab_v1_rows(capsys):
    """--v1: the first versions K1-v1 and K2-v1 compared the same way,
    one row each per S; without it the line has no v1_rows."""
    assert k2_ab.main(['--other', ROOT, '--device', 'cpu', '--rays', '2',
                       '--reps', '1', '--shapes', '8', '--v1']) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r['kernel'], r['S']) for r in rec['v1_rows']] == [
        ('K1-v1', 8), ('K2-v1', 8)]
    for r in rec['v1_rows']:
        assert set(r) == K1_ROW_KEYS | {'kernel'} and r['bit_equal'] is True
    assert k2_ab.main(['--other', ROOT, '--device', 'cpu', '--rays', '2',
                       '--reps', '1', '--shapes', '8']) == 0
    assert 'v1_rows' not in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


def test_k2_ab_shape_rows(capsys):
    """--shape: the kernel_bench tool's --layered network in place of the
    flagship's, K3 compared as K1 is (bit-equal on the CPU), the shape in
    the line; the saved activations' rows need the card (none here)."""
    assert k2_ab.main(['--other', ROOT, '--device', 'cpu', '--rays', '2',
                       '--reps', '1', '--shapes', '8', '--shape',
                       'wide-input']) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['shape'] == 'wide-input' and rec['act_rows'] == []
    assert [r['S'] for r in rec['k3_rows']] == [8]
    for r in rec['k3_rows'] + rec['k1_rows'] + rec['rows']:
        assert r['bit_equal'] is True
    assert set(rec['k3_rows'][0]) == K1_ROW_KEYS
