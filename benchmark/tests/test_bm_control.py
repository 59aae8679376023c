"""The control: the reference in fp8 put in the program's place reads
further from the reference than the program does, on a cell's numbers.
At a tiny size on the CPU, and (marked `gpu`) at the cells' own size on
the card, where it has to come out not correct."""
import json
import re
import subprocess
import sys

import pytest

from benchmark import control, harness
from conftest import ROOT, tiny_cell


def _program_readings(cell, seeds):
    return [harness.run_cell(cell, s, 0.5, False, 'cpu')['checks']
            for s in seeds]


@pytest.mark.parametrize('cell', ['surreal.train', 'surreal_single.render'])
def test_control_reads_further_than_the_program(cell):
    c = tiny_cell(cell)
    prog = _program_readings(c, [1, 2])
    s = control.summary(control.readings(c, [1, 2], ['control'],
                                         device='cpu'))
    further = [k for k in c.limits if k != 'box_mismatch'
               and s[k]['control_min'] > 1.2 * max(
                   p[k]['value'] for p in prog if k in p)]
    assert further, s


def test_the_half_batch_fault_fails_the_train_check():
    c = tiny_cell('surreal.train')
    rows = control.readings(c, [3], ['half'], device='cpu')
    assert not harness.is_correct(harness.judge(rows[0]['readings'],
                                                c.limits))


@pytest.mark.gpu
@pytest.mark.parametrize('cell', ['surreal.train', 'surreal_single.render'])
def test_control_fails_at_size_on_the_card(card, cell):
    run = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         '4000000005', '--seconds', '3', '--trace', '0'], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])['correct']
    p = subprocess.run(
        [sys.executable, 'benchmark/control.py', '--workload', cell,
         '--seeds', '5', '--modes', 'control'], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(x) for x in p.stdout.splitlines()
            if re.match(r'\{"seed"', x)]
    limits = harness.load_json(harness.HERE / 'limits' / f'{cell}.json')
    assert rows and not any(
        harness.is_correct(harness.judge(r['readings'], limits))
        for r in rows)
