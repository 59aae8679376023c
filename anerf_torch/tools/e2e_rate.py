"""The in-loop end-to-end training rate on the headline config (torch
port of tools/e2e_rate.py):

    python -m anerf_torch.tools.e2e_rate [--steps 8000] [--warm_steps 2000]
        [--cull 0.125] [--no_fast] [--workers 4] [--unroll 20]
        [--device cuda]

A thin CLI over `anerf_torch.tools.bench.measure_e2e`, the measurement
behind the bench line's `e2e_inloop_rays_per_sec`. Prints one JSON line.
It runs on the GPU and raises without one; `--device cpu` for tests.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=8000)
    p.add_argument('--warm_steps', type=int, default=2000)
    p.add_argument('--cull', type=float, default=0.125)
    p.add_argument('--no_fast', action='store_true')
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--unroll', type=int, default=20)
    p.add_argument('--device', type=str, default='cuda')
    a = p.parse_args(argv)

    from .. import resolve_device
    from .bench import device_line, measure_e2e

    resolve_device(a.device)
    rate, prof = measure_e2e(
        steps=a.steps, warm_steps=a.warm_steps, cull_ratio=a.cull,
        fast_grads=not a.no_fast, workers=a.workers, unroll=a.unroll,
        device=a.device)
    line = {
        'metric': 'e2e_inloop_rays_per_sec',
        'value': round(rate, 1),
        'per_1k_rates': prof,
        'unit': 'rays/s',
        'config': ('cull %.3g %s, workers=%d unroll=%d' % (
            a.cull, 'strict' if a.no_fast else 'fast', a.workers,
            a.unroll)),
        'device': device_line(a.device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
