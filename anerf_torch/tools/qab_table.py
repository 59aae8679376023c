"""Render the quality A/B's JSONL (`python -m anerf_torch.tools.quality_ab
--ab_state ...`, or bench.py's) as PERF.md's tables: per-(style, variant)
PSNR mean +/- std with n, the paired deltas against each variant's
control (culled - control, refine_culled - refine, as PAIRING pairs
them), and the pose-refinement MPJPE summary. The port's copy of the
JAX package's tools/qab_table.py: on bench.py's rows it prints the same
text. Fused-branch rows (config `<variant>+fused`) get a table of their
own and pair within their branch (culled+fused - control+fused); where
both branches are present, one more table gives fused - plain for the
same variant, style and seed.

No device. Usage:
    python -m anerf_torch.tools.qab_table anerf_torch/tools/quality_ab_h100.jsonl
"""
import json
import statistics
import sys
from collections import defaultdict

PAIRING = {'culled': 'control', 'refine': 'control',
           'refine_culled': 'refine', 'refine_warm': 'control',
           'refine_culled_warm': 'refine_warm', 'fast': 'control',
           'sr': 'control', 'sr_culled': 'control', 'fastv2': 'control'}
FUSED = '+fused'
DEFAULT = 'anerf_torch/tools/quality_ab_h100.jsonl'


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if 'config' not in r and 'tag' in r:   # round-3 schema
                r['config'] = r['tag']
            rows.append(r)
    # dedup on the resume key (or full identity for keyless old rows),
    # last write wins
    return list({tuple(r.get('key',
                             (r['style'], r['seed'], r['config']))): r
                 for r in rows}.values())


def fmt(mean, std, n):
    return f'{mean:.2f} ± {std:.2f} (n={n})' if n > 1 else f'{mean:.2f}'


def split(config):
    """'culled+fused' -> ('culled', '+fused'); 'culled' -> ('culled', '')."""
    if config.endswith(FUSED):
        return config[:-len(FUSED)], FUSED
    return config, ''


def _order(v):
    base, suffix = split(v)
    return (suffix != '', base != 'control', base)


def _deltas(rows, styles, v, base):
    """v's PSNR minus base's, per (style, seed) where both ran."""
    deltas = []
    for s in styles:
        bysd = defaultdict(dict)
        for r in rows:
            if r['style'] == s and r['config'] in (v, base):
                bysd[r['seed']][r['config']] = r
        for sd, d in sorted(bysd.items()):
            if v in d and base in d:
                deltas.append(d[v]['psnr'] - d[base]['psnr'])
    return deltas


def _delta_row(label, deltas):
    print(f'| {label} | {statistics.median(deltas):+.2f} | '
          f'{statistics.mean(deltas):+.2f} | '
          f'{statistics.pstdev(deltas):.2f} | {len(deltas)} |')


def _psnr_table(styles, variants, cells):
    print('| style | ' + ' | '.join(variants) + ' |')
    print('|' + '---|' * (len(variants) + 1))
    for s in styles:
        out = [s]
        for v in variants:
            rs = cells.get((s, v), [])
            if not rs:
                out.append('—')
                continue
            ps = [r['psnr'] for r in rs]
            out.append(fmt(statistics.mean(ps),
                           statistics.pstdev(ps) if len(ps) > 1 else 0.0,
                           len(ps)))
        print('| ' + ' | '.join(out) + ' |')


def main(path):
    rows = load(path)
    if not rows:
        print(f'no rows in {path}')
        return 1
    styles = sorted({r['style'] for r in rows})
    variants = sorted({r['config'] for r in rows}, key=_order)
    cells = defaultdict(list)          # (style, variant) -> [rows]
    for r in rows:
        cells[(r['style'], r['config'])].append(r)
    plain = [v for v in variants if not split(v)[1]]
    fused = [v for v in variants if split(v)[1]]

    print(f'Source: {path} — {len(rows)} cells, '
          f'{len(styles)} styles x {len(variants)} variants\n')
    if plain:
        _psnr_table(styles, plain, cells)
    if fused:
        print('\nFused branch (fused_kernel; K1, K2):\n' if plain else '',
              end='')
        _psnr_table(styles, fused, cells)

    print('\nPaired deltas (variant − its control, per style×seed cell):\n')
    print('| pair | median ΔPSNR | mean | std | n |')
    print('|---|---|---|---|---|')
    for v in variants:
        b, suffix = split(v)
        base = PAIRING.get(b)
        if base is None or base + suffix not in variants:
            continue
        deltas = _deltas(rows, styles, v, base + suffix)
        if deltas:
            _delta_row(f'{v} − {base + suffix}', deltas)

    refine = [r for r in rows if 'mpjpe_mm' in r]
    if refine:
        print('\nPose refinement (perturbed-pose cells):\n')
        print('| variant | init MPJPE (mm) | refined MPJPE | PA-MPJPE | n |')
        print('|---|---|---|---|---|')
        for v in sorted({r['config'] for r in refine}):
            rs = [r for r in refine if r['config'] == v]
            med = lambda k: statistics.median([r[k] for r in rs])
            print(f"| {v} | {med('init_mpjpe_mm'):.1f} | "
                  f"{med('mpjpe_mm'):.1f} | {med('pa_mpjpe_mm'):.1f} | "
                  f"{len(rs)} |")

    pairs = [(v, v + FUSED) for v in plain if v + FUSED in fused]
    both = [(v, f, _deltas(rows, styles, f, v)) for v, f in pairs]
    both = [(v, f, d) for v, f, d in both if d]
    if both:
        print('\nFused − plain (the same variant, style and seed):\n')
        print('| pair | median ΔPSNR | mean | std | n |')
        print('|---|---|---|---|---|')
        for v, f, d in both:
            _delta_row(f'{f} − {v}', d)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT))
