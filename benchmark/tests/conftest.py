"""Shared pieces of the benchmark's own tests: the checkout's root on the
import path, the `gpu` marker (tests that need the card decide inside a
fixture and skip here), and cells cut to a size the CPU runs in seconds
with the port's plain kernels."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

#: a size the CPU holds: a 2-layer trunk of the published width (the
#: fused branch takes multiples of 256), 32 rays, 8 + 4 samples
TINY_CONFIG = dict(netdepth=2, N_rand=32, N_sample_images=4, N_samples=8,
                   N_importance=4, chunk=256)
#: limits for the tiny cells, by traffic kind: the plain kernels on the
#: CPU and two trunk layers read other gaps than the cells at size, so
#: the tests that need a verdict hold them to these, set from CPU
#: readings of the program (loss 1.8e-4, median leaf's gradient 3.3e-3,
#: the larger leaves' 3.3e-3, change 1.4e-2, the later dispatch's change
#: 4.1e-3, rgb 7e-5) and of the faults (0.1 to 1); the cells' own limits
#: are the ones set on the card
TINY_LIMITS = {'train': {'loss_gap': 1e-3, 'grad_gap_median': 2e-2,
                         'grad_gap_large': 2e-2, 'change_gap': 5e-2,
                         'change_gap_late': 5e-2},
               'render': {'rgb_max_gap': 1e-2, 'box_mismatch': 0.0}}
TINY_TRAFFIC = dict(n_frames=8, unroll=3, warm_dispatches=2,
                    trace_dispatches=1, H=32, W=32, frames=[0, 3],
                    n_views=4, check_requests=1, trace_requests=4)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA card; skipped without one')


def tiny_cell(name: str, base: Path = harness.HERE) -> harness.Cell:
    """The cell `name` of the BENCHMARK.json beside `base`, cut to
    TINY_CONFIG / TINY_TRAFFIC and held to TINY_LIMITS."""
    spec = harness.load_json(base.parent / 'BENCHMARK.json')
    cell = harness.load_cell(spec, name, base)
    cell.config['train_config'].update(TINY_CONFIG)
    cell.traffic.update(TINY_TRAFFIC)
    cell.limits = dict(TINY_LIMITS[cell.traffic['kind']])
    return cell


@pytest.fixture
def card():
    """The card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
