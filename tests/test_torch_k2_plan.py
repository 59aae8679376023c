"""K2's plan (anerf_torch/kernels/fused_render.py: bwd_plan) and its split
by launch (kernels/roofline.py: k2_launch_bytes; the kernel_bench tool's
--k2_launches), on the CPU.

bwd_plan mirrors the host code of csrc/fused_render_bwd_sm90.cu: the
launches of one call in order, the CTAs of each layer launch by role, the
dW partials and the scratch buffers. The f32 flavour's plan is the one it
always had (BWD_CHUNK-point chunks, DX CTAs of BWD_DX_ITEMS tiles, f32
cotangents); the bf16 flavour's sizes its chunks from P so that a layer
launch fills the card at the culled point counts, keeps its MMA-layer
cotangents as bf16 tiles and its bias rows as partials of the DX groups
(`bias_map`). The per-launch HBM floors must add up to the design's.
Nothing is launched here; this file imports neither JAX nor the JAX
package.
"""
import pytest
import torch

from anerf_torch.kernels import fused_render as fr
from anerf_torch.kernels import roofline as rf
from anerf_torch.models.nerf import NeRFConfig
from anerf_torch.tools import kernel_bench as kb

FLAGSHIP = ('flagship', NeRFConfig(use_framecode=True, framecode_ch=16),
            7, 4)
CONFIGS = [FLAGSHIP] + [(name, *rf.shape_config(name))
                        for name in rf.SHAPES]
#: the culled fast-grads step's point counts (2048 rays at S = 8 and 24)
#: and the flagship's coarse net (S = 64)
POINTS = (16384, 49152, 131072)


def _packed(ncfg, nfk, nfv):
    """The widths bwd_plan reads of a packed net, without the weights."""
    fc = fr.fc_width(ncfg)
    k0, _, kv, _ = fr.input_widths(nfk, nfv, fc)
    return {'nfk': nfk, 'nfv': nfv, 'fc': fc, 'k0': k0, 'kv': kv}


def _layer_ctas(plan):
    return {ln['label']: ln['ctas'] for ln in plan['launches']
            if isinstance(ln['ctas'], dict)}


def test_f32_plan_matches_seq_add():
    """The f32 flavour: 14 launches at the flagship (recompute, heads, 10
    MMA layers, chunk sum, PE), 2048-point chunks, DX CTAs of 8 tiles, as
    Seq::add counts them, f32 cotangent rows."""
    _, ncfg, nfk, nfv = FLAGSHIP
    P = 2048 * 64
    plan = fr.bwd_plan(ncfg, _packed(ncfg, nfk, nfv), P, True)
    assert [ln['label'] for ln in plan['launches']] == (
        ['recompute', 'heads', 'view', 'feature']
        + [f'layer {i}' for i in range(7, -1, -1)] + ['chunk sum', 'PE'])
    assert len(plan['launches']) == 14
    assert (plan['chunk'], plan['n_chunk'], plan['dx_items']) == (2048, 64, 8)
    ctas = _layer_ctas(plan)
    # 2048 tiles; DX: ceil(2048 / 8) groups x 256-column tiles; DWT: 64
    # chunks x 64-output tiles x 256-column tiles (x0: 432 -> 2, xv: 672
    # -> 3)
    assert ctas['layer 3'] == {'dx': 256, 'dwt': 64 * 4}
    assert ctas['layer 0'] == {'dx': 256 * 2, 'dwt': 64 * 4 * 2}
    assert ctas['layer 5'] == {'dx': 256 * 3, 'dwt': 64 * 4 * 3}
    assert ctas['view'] == {'dx': 256 * 4, 'dwt': 64 * 2 * 4}
    heads = plan['launches'][1]
    assert heads['ctas'] == 64 * 13 + 2048
    f32 = torch.float32
    n_grad = sum(r * c for _, r, c in fr.grad_blocks(ncfg, nfk, nfv))
    assert n_grad == 867332
    assert plan['scratch'] == {
        'dhv': (f32, (P, 128)), 'dview': (f32, (P, 256 + 672)),
        'dh_a': (f32, (P, 256)), 'dh_b': (f32, (P, 256)),
        'dx0': (f32, (P, 432)), 'partial': (f32, (64, n_grad))}
    assert plan['cot_bytes'] == 4


def _source():
    """K2's kernel source and the header it takes TM from, whitespace
    collapsed."""
    return ' '.join(' '.join((fr._CSRC / f).read_text().split()) for f in (
        'fused_render_bwd_sm90.cu', 'fused_render_common.cuh'))


def test_bwd_plan_follows_the_kernel_source():
    """The mirror's constants are the kernel's (DX_ITEMS, DHV_SLAB, the
    64-point tile), and its CTA counts follow the host code's formulas:
    Seq::add's and SeqBf::add's n_ctas by role, the DX groups from the
    tiles and dx_items, and each flavour's heads grid (head_blocks: the
    rgb and alpha rows 32 a block in f32, 8 in bf16; then a block a tile,
    or a DX group's DHV_SLAB hv columns)."""
    import re
    text = _source()
    const = lambda name: int(re.search(rf'constexpr int {name} = (\d+);',
                                       text).group(1))
    assert const('DX_ITEMS') == fr.BWD_DX_ITEMS
    assert const('DHV_SLAB') == fr.DHV_SLAB
    assert const('TM') == fr.SLICE_K
    for formula in (
            # Seq::add (f32) and SeqBf::add (bf16)
            'p.n_ctas = kind == DX ? (L.pt_tiles + DX_ITEMS - 1) / '
            'DX_ITEMS * n_tiles : n_chunk * m_tiles * n_tiles;',
            'p.n_ctas = kind == DX ? n_dxg * n_tiles : n_chunk * '
            'slices_or_m * n_tiles;',
            'const int n_dxg = (pt_tiles + dx_items - 1) / dx_items;',
            'inline int head_rows(int w) { return w / 2 + 1 + w + 1; }',
            'return (head_rows(w) + (bf16 ? 7 : 31)) / (bf16 ? 8 : 32);',
            'heads_bwd_kernel<true><<<G.n_chunk * head_blocks(W, true) + '
            'n_dxg * (WV / DHV_SLAB),',
            'heads_bwd_kernel<false><<<n_chunk * head_blocks(W, false) + '
            'q.L.pt_tiles,',
            'inline int tiles256(int n) { return (n + NB - 1) / NB; }'):
        assert formula in text, formula
    assert re.search(r'constexpr int NB = 256;', text)
    assert fr.BWD_TILE_N == 256


@pytest.mark.parametrize('P,chunk,dx_items', [(16384, 1024, 4),
                                              (49152, 3072, 12),
                                              (131072, 8192, 32)])
def test_bf16_plan_fills_the_card(P, chunk, dx_items):
    """The bf16 flavour at the culled and the flagship point counts: 16
    chunks, DX CTAs of a quarter chunk (a DWT CTA's MMAs), so that a trunk
    layer launches 64 + 64 CTAs of equal work on 132 SMs (the f32
    flavour's culled coarse launch: 32 + 32); bf16 cotangent tiles; the
    bias partials one row a DX group."""
    _, ncfg, nfk, nfv = FLAGSHIP
    plan = fr.bwd_plan(ncfg, _packed(ncfg, nfk, nfv), P, False)
    T = P // 64
    assert (plan['chunk'], plan['n_chunk'], plan['dx_items'],
            plan['n_dx_groups']) == (chunk, 16, dx_items, 64)
    ctas = _layer_ctas(plan)
    assert ctas['layer 3'] == {'dx': 64, 'dwt': 64}
    assert ctas['feature'] == {'dx': 64, 'dwt': 64}
    assert ctas['layer 5'] == {'dx': 64 * 3, 'dwt': 16 * 4 * 3}
    assert ctas['view'] == {'dx': 64 * 4, 'dwt': 16 * 2 * 4}
    # a trunk layer's DX CTA does dx_items tiles x 4 output slices, a DWT
    # CTA one slice for each of the chunk's tiles
    assert dx_items * 4 == chunk // 64
    # the heads: a warp a row of the 16 chunks' rgb and alpha blocks (386
    # rows), a block a DX group's 32 hv columns
    assert plan['launches'][1]['ctas'] == 16 * 49 + 64 * 4
    bf, f32 = torch.bfloat16, torch.float32
    assert plan['scratch'] == {
        'dhv': (bf, (T, 128, 64)), 'dxv': (f32, (P, 672)),
        'dh_a': (bf, (T, 256, 64)), 'dh_b': (bf, (T, 256, 64)),
        'dx0': (f32, (P, 432)), 'partial': (f32, (16, 867332)),
        'bpart': (f32, (64, 9 * 256 + 128))}
    assert plan['cot_bytes'] == 2
    assert len(plan['launches']) == 14


@pytest.mark.parametrize('name,ncfg,nfk,nfv', CONFIGS[1:],
                         ids=[c[0] for c in CONFIGS[1:]])
@pytest.mark.parametrize('P', POINTS)
def test_bf16_plan_at_the_phase14_shapes(name, ncfg, nfk, nfv, P):
    """At every roofline.SHAPES network: the launches of the route the
    recompute takes (the layered route's phase A, layers and heads for
    wide-net and wide-input), one launch per MMA layer with its products'
    CTAs (DX: a group a 256-column tile of the segment; DWT: a chunk a
    64-output and 256-column tile), the DX groups a chunk's tiles over
    the trunk's output slices, every group and chunk covering the
    points once."""
    packed = _packed(ncfg, nfk, nfv)
    plan = fr.bwd_plan(ncfg, packed, P, False)
    W, T = ncfg.width, -(-P // 64)
    g = plan['chunk'] // 64
    assert g % fr.BF16_CHUNK_TILES == 0
    assert plan['n_chunk'] == -(-T // g) <= fr.BF16_CHUNKS
    assert plan['dx_items'] == max(1, g // (W // 64))
    assert plan['n_dx_groups'] == -(-T // plan['dx_items'])
    route = fr.route_plan(ncfg, packed['k0'], packed['kv'])
    n_re = 1 if route.kind == 'single' else ncfg.depth + 4
    labels = [ln['label'] for ln in plan['launches']]
    assert len(labels) == n_re + 1 + (ncfg.depth + 2) + 2
    assert all(lab.startswith('recompute') for lab in labels[:n_re])
    assert kb.k2_labels(plan) == ['recompute'] + labels[n_re:]
    _, k0p, _, kvp = fr.input_widths(nfk, nfv, packed['fc'])
    t = lambda n: -(-n // 256)
    skips = fr.skip_flags(ncfg)
    ctas = _layer_ctas(plan)
    n_dxg, n_chunk = plan['n_dx_groups'], plan['n_chunk']
    for i in range(ncfg.depth):
        segs = ([k0p] if i == 0 or skips[i] else []) + ([W] if i else [])
        assert ctas[f'layer {i}'] == {
            'dx': n_dxg * sum(map(t, segs)),
            'dwt': n_chunk * (W // 64) * sum(map(t, segs))}
    assert ctas['view'] == {'dx': n_dxg * (t(W) + t(kvp)),
                            'dwt': n_chunk * (W // 128) * (t(W) + t(kvp))}
    assert plan['scratch']['bpart'] == (
        torch.float32, (n_dxg, (ncfg.depth + 1) * W + W // 2))


@pytest.mark.parametrize('name,ncfg,nfk,nfv', CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_bias_map_points_at_each_layers_bias_row(name, ncfg, nfk, nfv):
    """bias_map: per MMA layer, in dW order, the flat offset of its
    block's last row (the bias), its width, and its column of the bias
    partials (trunk i at i W, feature at depth W, view at (depth + 1) W)."""
    blocks = fr.grad_blocks(ncfg, nfk, nfv)
    rows = fr.bias_map(ncfg, nfk, nfv)
    assert len(rows) == ncfg.depth + 2
    off, W = 0, ncfg.width
    for i, ((_, r, c), (at, n, col)) in enumerate(zip(blocks, rows)):
        assert (at, n, col) == (off + (r - 1) * c, c, i * W)
        off += r * c
    dW = torch.arange(sum(r * c for _, r, c in blocks), dtype=torch.float64)
    split = list(fr.split_grads(ncfg, nfk, nfv, dW).values())
    for (at, n, _), blk in zip(rows, split):
        assert torch.equal(blk[-1], dW[at:at + n])
    op = fr.bias_map_operand(ncfg, nfk, nfv, 'cpu')
    assert op.dtype == torch.int64 and op.tolist() == [list(r) for r in rows]
    assert fr.bias_map_operand(ncfg, nfk, nfv, 'cpu') is op


@pytest.mark.parametrize('name,ncfg,nfk,nfv', CONFIGS,
                         ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize('f32', [True, False])
def test_k2_launch_floors_add_up_to_the_design(name, ncfg, nfk, nfv, f32):
    """k2_launch_bytes: one floor per label of the plan's split (the
    recompute's launches as one), in order, summing to k2_design_bytes in
    the design each flavour runs (f32: 4-byte cotangents, 2048-point
    chunks; bf16: 2-byte tiles, the plan's chunks)."""
    packed = _packed(ncfg, nfk, nfv)
    fc = packed['fc']
    for P in (1000, *POINTS):
        plan = fr.bwd_plan(ncfg, packed, P, f32)
        chunk = plan['chunk']
        assert chunk == fr.BWD_CHUNK or not f32
        launches = rf.k2_launch_bytes(ncfg, nfk, nfv, P, plan['cot_bytes'],
                                      chunk, fc)
        assert [lab for lab, _ in launches] == kb.k2_labels(plan)
        assert sum(b for _, b in launches) == rf.k2_design_bytes(
            ncfg, nfk, nfv, P, chunk, plan['cot_bytes'], fc)
        assert all(b > 0 for _, b in launches)
        floors = kb.k2_floors(ncfg, packed, P, plan['cot_bytes'], chunk)
        assert list(floors) == kb.k2_labels(plan)
        assert sum(floors.values()) == pytest.approx(
            rf.k2_design_bytes(ncfg, nfk, nfv, P, chunk, plan['cot_bytes'],
                               fc) / rf.PEAK_HBM_BYTES * 1e3, rel=1e-12)


def test_k2_launch_floors_flagship_terms():
    """Spot values at the flagship (P = 16384): a plain trunk layer reads
    its cotangent twice and its input and mask, writes its input's
    cotangent (all c bytes an entry, c = 2 in the bf16 design) and its dW
    partials; the bf16 design's total is the f32 one's less the bytes the
    halved cotangents save."""
    _, ncfg, nfk, nfv = FLAGSHIP
    P, n = 16384, 16
    f32 = dict(rf.k2_launch_bytes(ncfg, nfk, nfv, P, 4, 1024))
    bf = dict(rf.k2_launch_bytes(ncfg, nfk, nfv, P, 2, 1024))
    assert f32['layer 3'] == (2 * 4 * 256 + 2 * 256 + 4 * 256 + 2 * 256) * P \
        + 4 * 257 * 256 * n
    assert bf['layer 3'] == (2 * 2 * 256 + 2 * 256 + 2 * 256 + 2 * 256) * P \
        + 4 * 257 * 256 * n
    assert f32['recompute'] == bf['recompute']
    assert f32['PE'] == bf['PE'] and f32['chunk sum'] == bf['chunk sum']


def _k2_events(plan, reps, us, lost=()):
    """Device kernel events of `reps` K2 calls in the plan's launch order,
    a fill kernel of another module before each call, launch i of call r
    taking us(i, r); (r, i) in `lost` dropped."""
    names = {'k1_sm90_kernel': 'void k1_sm90_kernel<0, true, 0, 3>(x)',
             'heads_bwd_kernel': 'void heads_bwd_kernel<true>(x)',
             'bwd_layer_kernel': 'bwd_layer_kernel_bf16(LayerArgsBf)',
             'reduce_chunks_kernel': 'reduce_chunks_kernel(x)',
             'pe_transform_bwd_kernel': 'pe_transform_bwd_kernel<false>(x)',
             'phase_a_act_kernel': 'phase_a_act_kernel(x)',
             'layer_gemm_kernel': 'layer_gemm_kernel<128, 2, true>(x)',
             'heads_kernel': 'heads_kernel(float*)'}
    ev, t = [], 0
    for r in range(reps):
        ev.append((t, 'vectorized_elementwise_kernel<Fill>', 1.0))
        t += 1
        for i, ln in enumerate(plan['launches']):
            if (r, i) not in lost:
                ev.append((t, names[ln['kernel']], us(i, r)))
            t += 1
    return ev[::-1]


@pytest.mark.parametrize('name', ['flagship', 'wide-net'])
def test_k2_split_names_launches_by_place(name):
    """k2_split_calls: the plan's kernels in start order, cut after each
    PE launch, the recompute's launches summed (one on the single
    kernel's route, depth + 4 on the layered route), the rest named by
    place; the median over whole calls; a call that lost a launch is left
    out; no whole call raises."""
    cfg = next(c for c in CONFIGS if c[0] == name)
    ncfg, nfk, nfv = cfg[1:]
    plan = fr.bwd_plan(ncfg, _packed(ncfg, nfk, nfv), 2048 * 8, False)
    labels = kb.k2_labels(plan)
    n_re = len(plan['launches']) - len(labels) + 1
    us = lambda i, r: 10.0 * (i + 1) + r
    per = kb.k2_split_calls(_k2_events(plan, 3, us), plan)
    assert list(per) == labels
    assert per['recompute'] == pytest.approx(
        sum(us(i, 1) for i in range(n_re)) / 1e3)
    for j, lab in enumerate(labels[1:]):
        assert per[lab] == pytest.approx(us(n_re + j, 1) / 1e3)
    # call 0 lost a layer launch: calls 1 and 2 remain (median of 2)
    per = kb.k2_split_calls(_k2_events(plan, 3, us, lost={(0, n_re + 3)}),
                            plan)
    assert per['PE'] == pytest.approx(
        (us(len(plan['launches']) - 1, 1)
         + us(len(plan['launches']) - 1, 2)) / 2e3)
    with pytest.raises(RuntimeError, match='no whole call'):
        kb.k2_split_calls(_k2_events(plan, 1, us, lost={(0, 1)}), plan)


def test_k2_launches_arguments(monkeypatch):
    """--k2_launches takes no value (the flagship) or a roofline.SHAPES
    name, refuses the CPU and another mode beside it, and defaults to
    S = 64 80 8 24; nothing is launched here."""
    calls = []
    monkeypatch.setattr(kb, 'run', lambda *a, **k: calls.append((a, k)))
    for bad in (['--k2_launches', 'nope'],
                ['--k2_launches', '--device', 'cpu'],
                ['--k2_launches', '--layered', 'wide-net'],
                ['--k2_launches', '--decompose_bwd']):
        with pytest.raises(SystemExit):
            kb.main(bad)
    assert not calls
    assert kb.main(['--k2_launches']) == 0
    assert kb.main(['--k2_launches', 'wide-input', '--shapes', '64']) == 0
    (a, k), (b, kk) = calls
    assert a == ('k2_launches', 2048, 8, [64, 80, 8, 24], 'cuda')
    assert k['shape'] == 'flagship'
    assert b[0] == 'k2_launches' and b[3] == [64]
    assert kk['shape'] == 'wide-input'


def test_k2_launches_rows_and_misses(monkeypatch):
    """`k2_launches` on the flagship's context, profiler and timer
    stubbed: per S and flavour one row a label and a 'call' row, each
    beside its flavour's floor (the call's the sum); a flavour whose
    windows all hold no whole call gets None launches and its misses
    counted, its call still timed. Nothing is launched."""
    ctx = kb.setup(4, 'cpu')

    def profiled(fn, arg_sets, reps):
        f32 = arg_sets[0][-1] is True
        if len(arg_sets[0]) == 8 or not f32 and arg_sets[0][2].shape[1] == 8:
            return []                   # the warm-up; bf16 at S = 8 misses
        plan = fr.bwd_plan(ctx['ncfg'], ctx['packed'],
                           arg_sets[0][2].shape[0] * arg_sets[0][5], f32)
        return _k2_events(plan, reps, lambda i, r: 10.0 * (i + 1))

    monkeypatch.setattr(kb, '_profiled', profiled)
    monkeypatch.setattr(kb, 'time_ms', lambda *a: 2.5)
    rows, misses, _ = kb.k2_launches(ctx, [8, 24], 3)
    assert misses == {'K2 bf16 S=8': kb.LAYERED_WINDOWS}
    by = {(r['kernel'], r['S'], r['launch']): r for r in rows}
    labels = kb.k2_labels(fr.bwd_plan(ctx['ncfg'], ctx['packed'], 96, True))
    for flavour in ('K2 f32', 'K2 bf16'):
        for S in (8, 24):
            mine = [r for r in rows if (r['kernel'], r['S']) == (flavour, S)]
            assert [r['launch'] for r in mine] == labels + ['call']
            assert by[flavour, S, 'call']['ms'] == 2.5
            assert by[flavour, S, 'call']['floor_ms'] == pytest.approx(
                sum(r['floor_ms'] for r in mine[:-1]))
    assert by['K2 bf16', 8, 'heads']['ms'] is None
    assert by['K2 f32', 8, 'heads']['ms'] == pytest.approx(0.02)
    assert by['K2 bf16', 24, 'recompute']['ms'] == pytest.approx(0.01)
    assert by['K2 f32', 24, 'view']['floor_ms'] > \
        by['K2 bf16', 24, 'view']['floor_ms']
