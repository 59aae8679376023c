"""The port stands alone: no module of anerf_torch/, and not chip_smoke.py,
imports JAX or anything of the JAX package (anerf_tpu), not even the
JAX-free modules there (the port keeps its own copies)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / 'anerf_torch').rglob('*.py')) + \
    ['chip_smoke.py']
FORBIDDEN = ('jax', 'jaxlib', 'anerf_tpu', 'flax', 'optax', 'orbax')


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'id', None) == '__import__'
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize('path', FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


def test_scan_finds_the_port():
    assert 'anerf_torch/kernels/fused_render.py' in FILES
    for sub in ('train', 'pose'):
        assert f'anerf_torch/{sub}/__init__.py' in FILES
    assert 'anerf_torch/train/trainer.py' in FILES
    assert 'anerf_torch/pose/pose_opt.py' in FILES
    assert len(FILES) >= 26
    tree = ast.parse('import jax.numpy as jnp\nfrom anerf_tpu.ops import fk')
    assert [m for m in _imported_modules(tree)] == ['jax.numpy',
                                                    'anerf_tpu.ops']
