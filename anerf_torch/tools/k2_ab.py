"""K2 and K1 of this tree against K2 and K1 of another copy of the
package, in one process on one card: the same inputs, bit-equality of the
outputs, times in turns, and (in the bf16 flavour) each K2's MLP backward
against the plain bf16 one on its own saved activations.

    python -m anerf_torch.tools.k2_ab --other DIR [--bwd_bf16] [--v1]
        [--shape SHAPE] [--rays 2048] [--reps 11] [--shapes 64 80 8 24]
        [--device cuda]

DIR holds the other copy's `anerf_torch/` (e.g. `git archive` of another
commit, or this tree with one change to a kernel source); it is imported
under another name and builds its own kernels into DIR/anerf_torch/
_build. The inputs are the kernel_bench tool's (the flagship's coarse
net, random skeletons, points and cotangents from numpy's
default_rng(0)); times are medians of `reps` CUDA-event timings in turns
(other, this, this, other), each launch on the next of four input sets.
Per S it prints a row for K2 and one for K1's forward
(`fused_encode_mlp_pts` on the same points), and ends with one JSON line
{"metric": "k2_ab", "device", "power_limit", "bwd_f32", "rows": [{S,
bit_equal, outputs_bit_equal (dW, dpts, dm_all, daux each), ms,
other_ms, turns, fro, other_fro}], "k1_rows": [{S,
bit_equal, ms, other_ms, turns}]}; fro is the worst relative Frobenius
distance of a dW block, dx0 or dxv from the plain bf16 MLP backward on
the kernel's own activations (None in the f32 flavour). With --v1 the
line also holds "v1_rows": [{kernel, S, bit_equal, ms, other_ms,
turns}], the first versions K1-v1 and K2-v1 (f32) compared the same
way. With --shape (a roofline.SHAPES name: the kernel_bench tool's
--layered network, random weights from seed 0) the line also holds
"k3_rows" (K3 on build_raw_inputs of the same points) and "act_rows"
[{S, bit_equal, raw_bit_equal}]: K2's recompute alone (launch_bwd stopped
after it), its saved activations (the tiles of the points; the spare
tile is scratch) and raw compared bit for bit. The other copy's
`fused_bwd` must take `bwd_f32` for --bwd_bf16.
--device cpu runs the plain versions on the host clock, for the tests.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Sequence

import torch

from ..kernels import fused_render as fr
from . import kernel_bench as kb


def load_other(root: str):
    """The `anerf_torch` package under `root`, imported as
    anerf_torch_other; returns its kernels.fused_render module."""
    pkg = Path(root).resolve() / 'anerf_torch'
    name = 'anerf_torch_other'
    spec = importlib.util.spec_from_file_location(
        name, pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f'{name}.kernels.fused_render')


def mlp_fro(ofr, ncfg, packed, args, bwd_f32: bool) -> float:
    """`ofr`'s K2 stopped after its MLP backward (on a card; the plain
    version on the CPU) against the plain bf16 MLP backward on its saved
    activations: the worst relative Frobenius distance of a dW block,
    dx0 or dxv."""
    P, W = args[2].shape[0] * args[5], ncfg.width
    if args[2].device.type == 'cpu':
        dW, dx0, dxv = fr.mlp_bwd_ref(*args, bwd_f32=bwd_f32)
        got, want = (dW, dx0.reshape(P, -1), dxv.reshape(P, -1)), \
            fr.mlp_bwd_ref(*args, bwd_f32=False)
    else:
        t = ofr.launch_bwd(2, *args, bwd_f32=bwd_f32)
        # the other copy may predate 'dxv' (its dview is d[feat | xv])
        got = (t['dW'], t['dx0'], t['dxv'] if 'dxv' in t
               else t['dview'][:, W:])
        want = fr.mlp_bwd_ref(*args, bwd_f32=False, trace=fr.trace_from_act(
            ncfg, packed, t['act'], P))
    nfk, nfv = packed['nfk'], packed['nfv']
    pairs = list(zip(fr.split_grads(ncfg, nfk, nfv, got[0]).values(),
                     fr.split_grads(ncfg, nfk, nfv, want[0]).values()))
    pairs += [(got[1], want[1].reshape(P, -1)),
              (got[2], want[2].reshape(P, -1))]
    return max(((a - b).norm() / b.norm().clamp_min(1e-7)).item()
               for a, b in pairs)


def ab_row(S: int, this, that, ins, reps: int, dev, each: bool = False
           ) -> Dict[str, Any]:
    """`this` against `that` on the input sets `ins`: bit-equality of
    their outputs on the first set (with `each`, also output by output),
    and their times in turns (that, this, this, that)."""
    a, b = this(*ins[0]), that(*ins[0])
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    turns = [kb.time_ms(fn, ins, reps, dev) for fn in (that, this, this,
                                                       that)]
    row = {'S': S, 'bit_equal': all(same), 'ms': (turns[1] + turns[2]) / 2,
           'other_ms': (turns[0] + turns[3]) / 2, 'turns': turns}
    if each:
        row['outputs_bit_equal'] = same
    return row


def act_row(S: int, ofr, args) -> Dict[str, Any]:
    """K2's recompute of this tree and of `ofr` on the same operands:
    bit-equality of the saved activations of the points' tiles and of
    raw."""
    a, b = fr.launch_bwd(1, *args), ofr.launch_bwd(1, *args)
    ncfg, packed = args[0], args[1]
    P = args[2].shape[0] * args[5]
    n = -(-P // fr.SLICE_K) * fr.act_rows(ncfg, packed['nfk'],
                                          packed['nfv'])['F'] * fr.SLICE_K
    return {'S': S, 'bit_equal': torch.equal(a['act'][:n], b['act'][:n]),
            'raw_bit_equal': torch.equal(a['raw'], b['raw'])}


def run(other: str, n_rays: int = 2048, reps: int = 11,
        shapes: Sequence[int] = (64, 80, 8, 24), bwd_f32: bool = True,
        device='cuda', v1: bool = False, shape: str | None = None
        ) -> Dict[str, Any]:
    """Both K2s and both K1s per S (with `v1`, both K1-v1s and K2-v1s
    too; with `shape`, at that roofline.SHAPES network, both K3s and both
    K2 recomputes' saved activations too); prints their rows per S and
    the JSON line, and returns the JSON object."""
    ofr = load_other(other)
    ctx = kb.setup(n_rays, device) if shape is None else \
        kb.shape_setup(shape, n_rays, device)
    dev = ctx['dev']
    kw = {} if bwd_f32 else {'bwd_f32': False}
    this = lambda *a: fr.fused_bwd(*a, **kw)
    that = lambda *a: ofr.fused_bwd(*a, **kw)
    rows: List[Dict[str, Any]] = []
    k1_rows: List[Dict[str, Any]] = []
    v1_rows: List[Dict[str, Any]] = []
    k3_rows: List[Dict[str, Any]] = []
    act_rows: List[Dict[str, Any]] = []
    for S in shapes:
        sets = kb.input_sets(ctx, S)
        k1_ins = kb._k1_args(ctx, sets, S)
        k1 = ab_row(S, fr.fused_encode_mlp_pts, ofr.fused_encode_mlp_pts,
                    k1_ins, reps, dev)
        k1_rows.append(k1)
        print({'kernel': 'K1', **k1}, flush=True)
        ins = [a + (s['g'],) for a, s in zip(k1_ins, sets)]
        if shape is not None:
            raw = [(ctx['ncfg'], ctx['packed'], fr.build_raw_inputs(
                s['pts'], ctx['rays_d'], ctx['skts'], ctx['fc']),
                ctx['tau']) for s in sets]
            k3_rows.append(ab_row(S, fr.fused_encode_mlp,
                                  ofr.fused_encode_mlp, raw, reps, dev))
            print({'kernel': 'K3', **k3_rows[-1]}, flush=True)
            if dev.type == 'cuda':
                act_rows.append(act_row(S, ofr, ins[0]))
                print({'kernel': 'K2 recompute', **act_rows[-1]},
                      flush=True)
        row = {**ab_row(S, this, that, ins, reps, dev, each=True),
               'fro': None, 'other_fro': None}
        if not bwd_f32:
            row['fro'] = mlp_fro(fr, ctx['ncfg'], ctx['packed'], ins[0],
                                 False)
            row['other_fro'] = mlp_fro(ofr, ctx['ncfg'], ctx['packed'],
                                       ins[0], False)
        rows.append(row)
        print(row, flush=True)
        if v1:
            for kernel, args, name in (
                    ('K1-v1', k1_ins, 'fused_encode_mlp_pts_v1'),
                    ('K2-v1', ins, 'fused_bwd_v1')):
                v1_rows.append({'kernel': kernel, **ab_row(
                    S, getattr(fr, name), getattr(ofr, name), args, reps,
                    dev)})
                print(v1_rows[-1], flush=True)
    rec = {'metric': 'k2_ab', **kb.card(dev), 'bwd_f32': bwd_f32,
           'other': other, 'rows': rows, 'k1_rows': k1_rows}
    if v1:
        rec['v1_rows'] = v1_rows
    if shape is not None:
        rec.update(shape=shape, k3_rows=k3_rows, act_rows=act_rows)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--other', required=True,
                   help='directory holding the other anerf_torch/')
    p.add_argument('--rays', type=int, default=2048)
    p.add_argument('--reps', type=int, default=11)
    p.add_argument('--shapes', nargs='+', type=int, default=[64, 80, 8, 24])
    p.add_argument('--bwd_bf16', action='store_true',
                   help="K2's bf16-cotangent flavour (both copies)")
    p.add_argument('--v1', action='store_true',
                   help='also K1-v1 and K2-v1 against the other copy')
    p.add_argument('--shape', default=None,
                   help='a roofline.SHAPES network (kernel_bench '
                        '--layered\'s) in place of the flagship\'s; adds K3 '
                        'and the saved activations')
    p.add_argument('--device', default='cuda',
                   help="'cpu' runs the plain versions (for the tests)")
    a = p.parse_args(argv)
    run(a.other, a.rays, a.reps, a.shapes, not a.bwd_bf16, a.device,
        a.v1, a.shape)
    return 0


if __name__ == '__main__':
    sys.exit(main())
