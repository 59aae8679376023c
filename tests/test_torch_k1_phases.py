"""The K1 phase-stamp tool (anerf_torch/tools/k1_phases.py) on the CPU:
every variant's edits and every stamp anchor still match the kernel
source exactly once, so the tool measures the kernel the port runs. The
tool itself needs a GPU and nvcc."""
import pytest

from anerf_torch.tools import k1_phases as kp


@pytest.mark.parametrize('variant', sorted(kp.VARIANTS))
def test_every_variant_instruments_the_kernel(variant):
    src = kp.instrumented_source(variant)
    for i in range(len(kp.PHASES) + 1):
        assert src.count(f'g_stamp[blockIdx.x * 8 + {i}]') == 1
    assert 'anerf_read_stamps' in src


def test_phases_follow_the_anchors():
    assert len(kp.ANCHORS) == len(kp.PHASES) == 7


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(kp.torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        kp.run(['base'])
