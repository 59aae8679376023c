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
    for mod in ('kernels/fused_mlp.py', 'kernels/stages.py',
                'tools/__init__.py', 'tools/flagship.py',
                'tools/kernel_bench.py',
                # the training entry point and its data layer
                'data/__init__.py', 'data/schema.py', 'data/fixtures.py',
                'data/dataset.py', 'data/surreal.py', 'data/catalog.py',
                'data/pipeline.py', 'native/__init__.py',
                'train/checkpoint.py', 'train/loop.py', 'run_nerf.py',
                'utils/__init__.py', 'utils/metrics.py', 'utils/logging.py',
                'utils/skeleton_draw.py',
                # the render entry point and the modules behind it
                'run_render.py', 'render_mesh.py', 'render/catalog.py',
                'render/modes.py', 'pose/ckpt_compat.py',
                'utils/marching.py', 'utils/mesh_render.py',
                # the other dataset types, their converters, evaluation
                'data/h36m.py', 'data/perfcap.py', 'data/mixamo.py',
                'data/zju.py', 'data/mpi3dhp.py', 'data/process_mask.py',
                'data/smpl_tables.py', 'data/process_spin.py',
                'data/process_h36m.py', 'data/process_perfcap.py',
                'data/process_mixamo.py', 'data/process_zju.py',
                'data/process_3dhp.py', 'data/process_surreal.py',
                'utils/eval_helpers.py',
                # data parallel
                'parallel/__init__.py', 'parallel/mesh.py'):
        assert f'anerf_torch/{mod}' in FILES
    assert len(FILES) >= 75
    tree = ast.parse('import jax.numpy as jnp\nfrom anerf_tpu.ops import fk')
    assert [m for m in _imported_modules(tree)] == ['jax.numpy',
                                                    'anerf_tpu.ops']
