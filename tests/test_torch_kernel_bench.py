"""The port's kernel_bench tool (anerf_torch/tools/kernel_bench.py) and the
plain versions of the staged kernels K1-d and K2-d
(anerf_torch/kernels/stages.py), on the CPU.

The tool runs at --device cpu on a few rays (the plain PyTorch versions,
timed on the host clock); these tests check what it prints against the
JAX tool's JSON metric names and row keys (tools/kernel_bench.py), and
that its derived fields are the right differences. The stage digests'
plain versions must agree with the full plain versions wherever a stage
computes the same values: exactly where they take the same path, to f32
summation order where a digest sums them. The kernels are held to these
plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py). This file imports neither JAX nor the JAX package.
"""
import json

import pytest
import torch

from anerf_torch.kernels import fused_render as fr
from anerf_torch.kernels import stages
from anerf_torch.tools import kernel_bench as kb

# the TPU tool's keys (tools/kernel_bench.py), less those with no
# counterpart here (TR, max_t, pe_perray, split2; see the tool's
# docstring), plus TM
BENCH_KEYS = {'kind', 'S', 'TM', 'ms'}
DECOMPOSE_KEYS = {'S', 'TM', 'transform_ms', 'pe_ms', 'pe_notrig_ms',
                  'pe_libtrig_ms', 'full_ms', 'pe_only_ms', 'trig_ms',
                  'libtrig_extra_ms', 'mlp_only_ms'}
DECOMPOSE_BWD_KEYS = {'S', 'TM', 'bwd_f32', 'recompute_ms', 'mlp_ms',
                      'pe_ms', 'full_ms', 'mlp_bwd_ms', 'pe_bwd_ms',
                      'transform_bwd_ms'}


def _run(capsys, *flags):
    assert kb.main(['--device', 'cpu', '--rays', '2', '--reps', '1',
                    '--shapes', '8', '5', *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec['device'] == 'cpu' and rec['power_limit'] is None
    return rec


def test_bench_prints_kernel_bench_rows(capsys):
    rec = _run(capsys)
    assert rec['metric'] == 'kernel_bench'
    assert [(r['kind'], r['S']) for r in rec['rows']] == [
        (k, S) for S in (8, 5) for k in ('fwd', 'bwd_f32', 'fwd_raw', 'mlp')]
    for r in rec['rows']:
        assert set(r) == BENCH_KEYS and r['TM'] == kb.TM and r['ms'] > 0


def test_decompose_prints_stage_times_and_differences(capsys):
    rec = _run(capsys, '--decompose')
    assert rec['metric'] == 'kernel_decompose'
    assert [r['S'] for r in rec['rows']] == [8, 5]
    for r in rec['rows']:
        assert set(r) == DECOMPOSE_KEYS
        assert r['pe_only_ms'] == r['pe_ms'] - r['transform_ms']
        assert r['trig_ms'] == r['pe_ms'] - r['pe_notrig_ms']
        assert r['libtrig_extra_ms'] == r['pe_libtrig_ms'] - r['pe_ms']
        assert r['mlp_only_ms'] == r['full_ms'] - r['pe_ms']


def test_decompose_bwd_prints_stage_times_and_differences(capsys):
    rec = _run(capsys, '--decompose_bwd')
    assert rec['metric'] == 'kernel_decompose_bwd'
    for r in rec['rows']:
        assert set(r) == DECOMPOSE_BWD_KEYS and r['bwd_f32'] is True
        assert r['mlp_bwd_ms'] == r['mlp_ms'] - r['recompute_ms']
        assert r['pe_bwd_ms'] == r['pe_ms'] - r['mlp_ms']
        assert r['transform_bwd_ms'] == r['full_ms'] - r['pe_ms']


def test_bwd_bf16_is_not_ported():
    """--bwd_bf16 no longer raises: --decompose_bwd runs K2's bf16
    flavour, with the same keys and bwd_f32 False."""
    assert kb.main(['--device', 'cpu', '--rays', '2', '--reps', '1',
                    '--shapes', '8', '--decompose_bwd', '--bwd_bf16']) == 0


@pytest.mark.parametrize('mode', ['bench', 'decompose_bwd'])
def test_bwd_bf16_rows(capsys, mode):
    """The JAX tool's bwd_f32=False rows: kind 'bwd_bf16' after 'bwd_f32'
    in the default mode, and the stage times of the bf16 flavour with
    'bwd_f32': False under --decompose_bwd."""
    flags = ['--bwd_bf16'] + (['--decompose_bwd'] if mode != 'bench'
                              else [])
    rec = _run(capsys, *flags)
    if mode == 'bench':
        assert rec['metric'] == 'kernel_bench'
        assert [(r['kind'], r['S']) for r in rec['rows']] == [
            (k, S) for S in (8, 5)
            for k in ('fwd', 'bwd_f32', 'bwd_bf16', 'fwd_raw', 'mlp')]
        for r in rec['rows']:
            assert set(r) == BENCH_KEYS and r['ms'] > 0
        return
    assert rec['metric'] == 'kernel_decompose_bwd'
    assert [r['S'] for r in rec['rows']] == [8, 5]
    for r in rec['rows']:
        assert set(r) == DECOMPOSE_BWD_KEYS and r['bwd_f32'] is False
        assert r['mlp_bwd_ms'] == r['mlp_ms'] - r['recompute_ms']
        assert r['transform_bwd_ms'] == r['full_ms'] - r['pe_ms']


def test_no_card_no_cpu_flag_fails(monkeypatch):
    """Without a card the tool does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        kb.main(['--rays', '2', '--shapes', '8'])


@pytest.fixture(scope='module')
def ctx():
    c = kb.setup(3, 'cpu')
    c['S'] = 7
    c['set'] = kb.input_sets(c, 7)[1]
    return c


def _args(c, tau=2000.0):
    return (c['ncfg'], c['packed'], c['set']['pts'], c['m_all'], c['aux'],
            c['S'], tau)


@pytest.mark.parametrize('tau', [35.0, 2000.0])
def test_fwd_stage_digests_agree_with_plain_k1(ctx, tau):
    args = _args(ctx, tau)
    full = fr.fused_encode_mlp_pts_ref(*args)
    assert torch.equal(stages.decompose_fwd('full', *args), full)
    packed, pts, m_all, aux, S = args[1:6]
    pts_t, v, r = fr.geometry(pts, m_all, aux)
    x0, xv = fr._encode(packed, pts, m_all, aux, S, tau)
    fold = lambda x: x.reshape(*x.shape[:-1], -1, 4).sum(-2)
    pe = stages.decompose_fwd('pe', *args)
    assert pe.shape == full.shape
    torch.testing.assert_close(pe, fold(x0) + fold(xv))
    # the digest holds every live value: its sum is the sum of the inputs
    torch.testing.assert_close(pe.sum(-1), x0.sum(-1) + xv.sum(-1),
                               atol=1e-4, rtol=1e-5)
    # the plain fast-trig stage is the plain pe stage (accurate sin / cos)
    assert torch.equal(stages.decompose_fwd('pe_fasttrig', *args), pe)
    notrig = stages.decompose_fwd('pe_notrig', *args)
    assert not torch.allclose(notrig, pe)
    tr = stages.decompose_fwd('transform', *args)
    torch.testing.assert_close(tr[..., 0], v.sum(-1))
    torch.testing.assert_close(
        tr[..., 1:], (pts_t.reshape(*v.shape, 3)
                      / v[..., None].clamp_min(1e-12)).sum(-2))


def test_standin_trig_is_the_tpu_tools_polynomial():
    x = torch.linspace(-3.0, 3.0, 7)
    s, c = stages.standin_sincos(x)
    torch.testing.assert_close(s, x * 0.5 - x * x * 0.124)
    torch.testing.assert_close(c, 1.0 - x * x * 0.437)


def test_bwd_stage_digests_agree_with_plain_k2(ctx):
    args = _args(ctx) + (ctx['set']['g'],)
    dW, dpts, dm, daux = fr.fused_bwd_ref(*args)
    full = stages.decompose_bwd('full', *args)
    assert all(torch.equal(a, b) for a, b in zip(full, (dW, dpts, dm, daux)))
    (raw,) = stages.decompose_bwd('recompute', *args)
    assert torch.equal(raw, fr.fused_encode_mlp_pts_ref(*args[:-1]))
    mdW, dx0, dxv = stages.decompose_bwd('mlp', *args)
    assert torch.equal(mdW, dW)
    R, S = raw.shape[:2]
    _, k0p, _, kvp = fr.input_widths(7, 4)
    assert dx0.shape == (R, S, k0p) and dxv.shape == (R, S, kvp)
    pdW, digest = stages.decompose_bwd('pe', *args)
    assert torch.equal(pdW, dW) and digest.shape == (R, S, 3)
    # the third column sums the unit bone directions' cotangents
    nb = 24 * (1 + 2 * 7)
    torch.testing.assert_close(digest[..., 2], dx0[..., nb:nb + 72].sum(-1))
    # the first two feed the transform backward: dd sums to daux's view
    # block over the ray's samples
    torch.testing.assert_close(digest[..., 1].sum(1),
                               daux[:, 72:144].sum(-1), atol=1e-4,
                               rtol=1e-4)


def test_bwd_bf16_stage_digests_agree_with_plain_k2(ctx):
    """K2-d in the bf16 flavour: its stages are K2's bf16 plain version
    (dW at 'mlp' and 'pe' the same bits), and not the f32 flavour's."""
    args = _args(ctx) + (ctx['set']['g'],)
    want = fr.fused_bwd_ref(*args, bwd_f32=False)
    full = stages.decompose_bwd('full', *args, bwd_f32=False)
    assert all(torch.equal(a, b) for a, b in zip(full, want))
    mdW, dx0, dxv = stages.decompose_bwd('mlp', *args, bwd_f32=False)
    pdW, _ = stages.decompose_bwd('pe', *args, bwd_f32=False)
    assert torch.equal(mdW, want[0]) and torch.equal(pdW, want[0])
    f32dW, f32dx0, _ = stages.decompose_bwd('mlp', *args)
    assert not torch.equal(mdW, f32dW) and not torch.equal(dx0, f32dx0)


def test_stage_names_and_codes():
    assert list(stages.FWD_STAGES) == ['transform', 'pe', 'pe_notrig',
                                       'pe_fasttrig', 'full']
    assert stages.FWD_STAGES['full'] == stages.BWD_STAGES['full'] == 0
    assert list(kb.FWD_KEYS) == list(stages.FWD_STAGES)
    assert list(stages.BWD_STAGES) == ['recompute', 'mlp', 'pe', 'full']
    with pytest.raises(ValueError):
        stages.decompose_fwd('nope', *[None] * 7)
    with pytest.raises(ValueError):
        stages.decompose_bwd('nope', *[None] * 8)
