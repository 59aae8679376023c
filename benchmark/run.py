"""One run of one benchmark cell of the PyTorch / CUDA port:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It sets up the cell (`setup_s`: from the
start of this process to the first timed step or request), measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line: with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer ones from a profiled
window. The numbers that decide `correct` end both standard error and
the line. It exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), and when a module of JAX or of the
JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this script's folder, heads the import path
sys.path = [str(ROOT)] + [x for x in sys.path
                          if Path(x or '.').resolve() != ROOT / 'benchmark']

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    harness.set_cache_dirs(ROOT)
    spec = harness.load_json(ROOT / 'BENCHMARK.json')
    cell = harness.load_cell(spec, a.workload)

    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: the benchmark runs on the card only',
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 3

    out = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                           'cuda', T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f'forbidden modules loaded: {bad}', file=sys.stderr)
        return 4
    for k, c in out['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
