"""The speed of --sr_grads (stochastically rounded bf16 cotangents) on
the flagship's scanned step, with bench.py's protocol (torch port of
tools/sr_measure.py):

    python -m anerf_torch.tools.sr_measure [--device cuda]

Five builds of `anerf_torch.tools.bench.build` in one process, so that
their rates are comparable: default (f32 cotangents, the control),
fast_grads (round-to-nearest bf16 cotangents), sr_grads, sr_grads with
cull 0.125, and fast_grads with cull 0.125 (the plain branch's headline).
Each prints its median and best rays/s and its wall time (build and
measure); the last line is all five as one JSON object. All five run on
the plain branch (sr_grads has no fused counterpart). It runs on the GPU
and raises without one; `--device cpu` for tests.
"""
from __future__ import annotations

import argparse
import json
import time

#: (label, build overrides), tools/sr_measure.py's
CONFIGS = (
    ('default', {}),
    ('fast_grads', dict(fast_grads=True)),
    ('sr_grads', dict(sr_grads=True)),
    ('sr_cull0125', dict(sr_grads=True, cull_ratio=0.125)),
    ('fast_cull0125', dict(fast_grads=True, cull_ratio=0.125)),
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', type=str, default='cuda')
    a = p.parse_args(argv)

    from .. import resolve_device
    from .bench import build, device_line, measure

    if resolve_device(a.device).type == 'cuda':
        print(f'card: {device_line(a.device)}', flush=True)
    rows = {}
    for label, kw in CONFIGS:
        t0 = time.perf_counter()
        state, step_fn, stacks, rpd = build(device=a.device, **kw)
        med, best, _, _ = measure(state, step_fn, stacks, rpd)
        rows[label] = {'median': round(med, 1), 'best': round(best, 1),
                       'wall_s': round(time.perf_counter() - t0, 1)}
        print(label, rows[label], flush=True)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == '__main__':
    main()
