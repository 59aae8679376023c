"""benchmark/spans.py on the CPU at a tiny size: a run of each cell with
the port's spans measured stays correct and gives every layer of the
host split, `idle_by_span` over the profiled window, the rates of the
spans-off and spans-only windows and a span's cost off and on."""
import math

import pytest

from benchmark import spans
from conftest import tiny_cell

SPLIT = {'train': {'host_step_ms.train', 'host_raybatch_ms.train',
                   'host_autograd_ms.train', 'host_kernels_ms.train',
                   'host_adam_ms.train', 'upload_ms.train',
                   'step_self_share', 'idle_unspanned.train'},
         'render': {'host_request_ms.render', 'host_bucket_ms.render',
                    'device_wait_ms.render', 'idle_unspanned.render'}}


@pytest.mark.parametrize('cell', ['surreal.train', 'surreal_single.render'])
def test_a_run_gives_the_host_split(cell):
    c = tiny_cell(cell)
    out = spans.run(c, 2 ** 40 + 3, 0.3, 'cpu', repeats=1, calls=1000)
    assert out['correct']
    split = out['host_split']
    assert set(split) == SPLIT[c.traffic['kind']]
    assert all(math.isfinite(v) and v >= 0 for v in split.values())
    assert sum(out['idle_by_span'].values()) > 0
    assert len(out['rates']['off']) == len(out['rates']['on']) == 1
    assert min(out['rates']['off'] + out['rates']['on']) > 0
    assert set(out['span_cost']) == {'off_ns', 'on_ns'}
