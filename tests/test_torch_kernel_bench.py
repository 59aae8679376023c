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


# ---- --layered: the layered route split by launch (card only) ----

def test_layered_arguments(monkeypatch):
    """--layered takes a roofline.SHAPES name, refuses the CPU (the
    layered route runs on the card only) and another mode beside it, and
    defaults to S = 64 80; nothing is launched here."""
    from anerf_torch.kernels import roofline as rf
    calls = []
    monkeypatch.setattr(kb, 'run', lambda *a, **k: calls.append((a, k)))
    for bad in (['--layered', 'flagship'],
                ['--layered', 'wide-net', '--device', 'cpu'],
                ['--layered', 'wide-net', '--decompose'],
                ['--decompose', '--decompose_bwd']):
        with pytest.raises(SystemExit):
            kb.main(bad)
    assert not calls
    for shape in rf.SHAPES:
        assert kb.main(['--layered', shape]) == 0
    kb.main(['--layered', 'wide-input', '--shapes', '8', '--reps', '3'])
    kb.main([])
    (a, k), last = calls[-2], calls[-1]
    assert [c[1]['shape'] for c in calls[:-2]] == list(rf.SHAPES)
    assert all(c[0][0] == 'layered' and c[0][3] == [64, 80]
               for c in calls[:-2])
    assert a == ('layered', 2048, 3, [8], 'cuda')
    assert k == {'bwd_f32': True, 'shape': 'wide-input'}
    assert last[0][0] == 'bench' and last[0][3] == [64, 80, 8, 24]
    assert last[1]['shape'] is None


def test_layered_labels_follow_the_launch_sequence():
    """One layered call: phase A (not K4), a launch per MMA layer, the
    heads; K2's recompute the same launches as K1 (its saved activations
    are written where they are made: no copy launch)."""
    from anerf_torch.kernels import roofline as rf
    ncfg, _, _ = rf.shape_config('wide-net')
    trunk = [f'layer {i}' for i in range(8)] + ['feature', 'view']
    assert kb.layered_labels(ncfg, 'K4') == trunk + ['heads']
    assert kb.layered_labels(ncfg, 'K1') == ['phase A'] + trunk + ['heads']
    assert kb.layered_labels(ncfg, 'K2 recompute') == \
        ['phase A'] + trunk + ['heads']
    assert [kb.kind_of(lab) for lab in ('layer 3', 'feature', 'view',
                                        'heads', 'phase A')] == \
        ['layer', 'layer', 'layer', 'heads', 'phase A']
    names = {'void (anonymous namespace)::phase_a_kernel<0, true>(float)':
             'phase A',
             'void (anonymous namespace)::layer_gemm_kernel<128, 2, true>(x)':
             'layer',
             '(anonymous namespace)::heads_kernel(float*)': 'heads',
             'void at::native::vectorized_elementwise_kernel<4, Fill>':
             None}
    for name, kind in names.items():
        assert kb.launch_kind(name) == kind
    assert 'to_act' not in (kb.fr._CSRC
                            / 'fused_render_layered_sm90.cu').read_text()


def test_layered_floors_are_each_launchs_bytes():
    """layered_floors: each launch's own HBM bytes at 3.35 TB/s, in the
    order of layered_labels, summing to the design floor of the whole
    call (K4 at its embedded widths, K2's recompute with its saved
    activations)."""
    from anerf_torch.kernels import roofline as rf
    for shape in ('wide-net', 'wide-input'):
        ncfg, _, _ = rf.shape_config(shape)
        k0, kv = ncfg.dnet_input, kb.fm.view_in(ncfg)
        for kernel, save, emb in (('K1', False, False),
                                  ('K4', False, True),
                                  ('K2 recompute', True, False)):
            fl = kb.layered_floors(ncfg, kernel, k0, kv, 1000)
            assert list(fl) == kb.layered_labels(ncfg, kernel)
            a, b = kb.fm.kernel_widths(ncfg) if emb else (k0, kv)
            assert sum(fl.values()) == pytest.approx(
                rf.layered_design_bytes(ncfg, a, b, 1000, save, emb)
                / rf.PEAK_HBM_BYTES * 1e3, rel=1e-12)
    # the table's last column: each launch's floor summed over S, the
    # launches' and the call's their sum
    labels = kb.layered_labels(ncfg, 'K1')
    rows = [{'kernel': 'K1', 'S': S, 'launch': lab, 'kind': kb.kind_of(lab),
             'ms': 1.0, 'floor_ms': fl}
            for S in (64, 80) for lab, fl in [(lab, 0.25 * (i + 1))
                                              for i, lab in enumerate(labels)]
            + [('call', 2.0)]]
    lines = [ln.split() for ln in kb.layered_table(rows)]
    assert lines[0][-1] == 'floor'
    assert [float(ln[-1]) for ln in lines[1:1 + len(labels)]] == [
        0.5 * (i + 1) for i in range(len(labels))]
    total = 0.5 * len(labels) * (len(labels) + 1) / 2
    assert float(lines[-2][-1]) == float(lines[-1][-1]) == total


def _events(labels, reps, us):
    """Device kernel events of `reps` calls, a fill kernel of another
    module before each launch, launch i of call r taking us(i, r)."""
    name = {'phase A': 'phase_a_kernel<0>', 'heads': 'heads_kernel'}
    ev, t = [], 0
    for r in range(reps):
        for i, lab in enumerate(labels):
            ev.append((t, 'vectorized_elementwise_kernel<Fill>', 1.0))
            ev.append((t + 1, name.get(lab, 'layer_gemm_kernel<128, 2>'),
                       us(i, r)))
            t += 2
    return ev[::-1]                     # split_calls sorts by start


def test_layered_split_and_table():
    """split_calls names each launch by its place in a whole call and
    takes the median over the whole calls; a call that lost a launch to
    the profiler, or two calls merged by a lost last launch, are left
    out, and it raises when no whole call remains. The table sums each
    launch over S, gives its share of the kernel's launches, then the
    launches together and the whole call."""
    from anerf_torch.kernels import roofline as rf
    ncfg, _, _ = rf.shape_config('wide-input')
    labels = kb.layered_labels(ncfg, 'K1')
    n = len(labels)
    us = lambda i, r: 100.0 * (i + 1) + r
    per = kb.split_calls(_events(labels, 3, us), labels)
    assert per == {lab: (100.0 * (i + 1) + 1) / 1e3
                   for i, lab in enumerate(labels)}
    ev = sorted(_events(labels, 4, us))
    # a layer of call 0 and the heads ending call 2 lost: calls 0, 2 and
    # 3 are not whole, call 1 is
    lost = [e for j, e in enumerate(ev)
            if j not in (2 * 3 + 1, 2 * (2 * n + n - 1) + 1)]
    assert kb.split_calls(lost, labels) == {
        lab: us(i, 1) / 1e3 for i, lab in enumerate(labels)}
    with pytest.raises(RuntimeError, match='no whole call'):
        kb.split_calls(_events(labels, 1, us)[1:], labels)
    with pytest.raises(RuntimeError, match='no whole call'):
        kb.split_calls(_events(['phase A', 'heads'] * 6, 1, us), labels)
    rows = [{'kernel': 'K1', 'S': S, 'launch': lab, 'kind': kb.kind_of(lab),
             'ms': ms * S / 64, 'floor_ms': 0.0} for S in (64, 80)
            for lab, ms in list(per.items()) + [('call', 9.0)]]
    lines = kb.layered_table(rows)
    assert lines[0].split() == ['kernel', 'launch', 'S=64', 'S=80', 'sum',
                                'share', 'floor']
    assert len(lines) == 1 + len(labels) + 2
    body = [ln.split() for ln in lines[1:1 + len(labels)]]
    assert [b[1] if b[1] != 'phase' else 'phase A' for b in body] == [
        lab.split()[0] if lab.startswith('layer') else lab
        for lab in labels]
    total = sum(per.values()) * (1 + 80 / 64)
    for (lab, ms), b in zip(per.items(), body):
        assert float(b[-3]) == pytest.approx(ms * (1 + 80 / 64), abs=1e-4)
        assert float(b[-2].rstrip('%')) == pytest.approx(
            100 * ms * (1 + 80 / 64) / total, abs=0.06)
    launches, call = lines[-2].split(), lines[-1].split()
    assert launches[1] == 'launches' and launches[-2] == '100.0%'
    assert float(launches[-3]) == pytest.approx(total, abs=1e-3)
    assert call[1:] == ['call', '9.0000', '11.2500', '20.2500', '0.0000']


def test_layered_reports_the_profiler_misses(monkeypatch):
    """`layered` retries a window that holds no whole call up to
    LAYERED_WINDOWS times, counts the windows missed, and where all of
    them miss leaves that kernel's launches at that S unmeasured (None,
    'n/m' in the table) instead of failing; the whole call is still
    timed. Profiler and timer are stubbed: nothing is launched."""
    ctx = kb.shape_setup('wide-input', 4, 'cpu')
    windows = {'K1': 0, 'K4': 0, 'K2 recompute': 0}

    def profiled_by_kernel(fn, arg_sets, reps):
        kernel = next(k for k, f in names.items() if f(fn))
        windows[kernel] += 1
        labels = kb.layered_labels(ctx['ncfg'], kernel)
        # K4's first window (S = 64) and every one at S = 80 hold no
        # whole call
        if kernel == 'K4' and (windows['K4'] == 1
                               or arg_sets[0][2].shape[0] == 4 * 80):
            return []
        return _events(labels, reps, lambda i, r: 10.0 * (i + 1))

    names = {'K1': lambda f: f is kb.fr.fused_encode_mlp_pts,
             'K4': lambda f: f is kb.fm.fused_mlp_apply,
             'K2 recompute': lambda f: f not in (
                 kb.fr.fused_encode_mlp_pts, kb.fm.fused_mlp_apply)}
    monkeypatch.setattr(kb, '_profiled', profiled_by_kernel)
    monkeypatch.setattr(kb, 'time_ms', lambda *a: 1.5)
    rows, misses, seen = kb.layered(ctx, [64, 80], 3)
    assert 'heads_kernel' in seen['K2 recompute']
    assert not any('to_act' in n for names in seen.values() for n in names)
    assert misses == {'K4 S=64': 1, 'K4 S=80': kb.LAYERED_WINDOWS}
    assert windows == {'K1': 3, 'K4': 2 + kb.LAYERED_WINDOWS,
                       'K2 recompute': 2}
    by = {(r['kernel'], r['S'], r['launch']): r['ms'] for r in rows}
    assert by['K4', 64, 'heads'] == pytest.approx(0.11)
    assert by['K4', 80, 'heads'] is None and by['K4', 80, 'call'] == 1.5
    assert by['K1', 80, 'phase A'] == pytest.approx(0.01)
    lines = [ln.split() for ln in kb.layered_table(rows)]
    k4 = {ln[1]: ln[2:] for ln in lines if ln[0] == 'K4'}
    # the last column: each launch's floor (measured or not)
    floor = sum(r['floor_ms'] for r in rows
                if r['kernel'] == 'K4' and r['launch'] == 'heads')
    assert k4['heads'] == ['0.1100', 'n/m', 'n/m', f'{floor:.4f}']
    assert k4['launches'][:3] == ['0.6600', 'n/m', 'n/m']
    assert k4['call'][:3] == ['1.5000', '1.5000', '3.0000']
    assert k4['call'][3] == k4['launches'][3]
    k1 = {ln[1]: ln[2:] for ln in lines if ln[0] == 'K1'}
    assert k1['launches'][-2] == '100.0%'
