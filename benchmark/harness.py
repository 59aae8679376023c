"""The data-driven harness: a cell of BENCHMARK.json is found by name,
its configuration (`configs/<config>.json`) and traffic mix
(`traffic/<traffic>.json`) by theirs; the mix's `kind` picks one of the
general drivers (`drivers/<kind>.py`), each per-layer metric is read by
its own reader (`metrics/<metric>.py`), and the numbers that decide
`correct` are held to the cell's limits (`limits/<workload>.json`)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent

#: top-level module names that no run may load: JAX, its libraries and
#: the JAX package the program was ported from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'anerf_tpu')


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with everything it names."""
    name: str
    config: dict
    traffic: dict
    chips: int
    spec: dict
    limits: dict

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec['end_to_end']
                if self.name in m.get('workloads', [self.name])]

    @property
    def per_layer(self) -> List[dict]:
        return [m for m in self.spec['per_layer']
                if self.name in m.get('workloads', [self.name])
                and any(e['name'] == m['moves'] for e in self.end_to_end)]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(spec: dict, workload: str, base: Path = HERE) -> Cell:
    """The cell named `workload` of a loaded BENCHMARK.json, with its
    files read from under `base`."""
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json '
                         f'(have {sorted(cells)})')
    w = cells[workload]
    config = load_json(base / 'configs' / f'{w["config"]}.json')
    traffic = load_json(base / 'traffic' / f'{w["traffic"]}.json')
    limits = load_json(base / 'limits' / f'{workload}.json')
    return Cell(workload, config, traffic, int(w['chips']), spec, limits)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc libraries already live in anerf_torch/_build/), and
    no library loading JAX or Flax on its own."""
    cache = root / '.bench_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TORCHINDUCTOR_CACHE_DIR'] = str(cache / 'inductor')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def driver(kind: str):
    return importlib.import_module(f'benchmark.drivers.{kind}')


def reader(metric: str, base: Path = HERE) -> Callable[[dict], Optional[float]]:
    """The `read(ctx)` of metrics/<metric>.py (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = base / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{number: {'value', 'limit'}} for every number the limits name; a
    number that was not read is NaN, which no limit admits."""
    return {k: {'value': float(readings.get(k, float('nan'))),
                'limit': float(lim)} for k, lim in limits.items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', t_start: Optional[float] = None,
             base: Path = HERE, **driver_kw) -> dict:
    """One run of a cell: set-up, window and check (drivers/<kind>.py),
    then the per-layer readers on a traced run. Returns the result object
    (the last line a run prints), its 'checks' last."""
    import time
    if t_start is None:
        t_start = time.perf_counter()
    run = driver(cell.traffic['kind']).run(
        cell, seed, seconds, trace, device, t_start, **driver_kw)
    checks = judge(run['readings'], cell.limits)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m['name'], base)(run['ctx'])
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            v = run['end_to_end'].get(m['name'])
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    device_info = dict(run['device'])
    out = {'correct': is_correct(checks), 'attempted': run['attempted'],
           'failed': run['failed'], 'metrics': metrics,
           'device': device_info}
    extra = {k: v for k, v in run['end_to_end'].items() if k not in metrics}
    if trace:
        tr = run['ctx']['trace']
        extra['attribution'] = tr['rules']
    print(f'run info {json.dumps(extra)}; readings '
          f'{json.dumps(run["readings"])}', file=sys.stderr)
    if trace:
        device_info['busy_s'] = tr['busy_s']
        device_info['window_s'] = tr['window_s']
        out['breakdown'] = {'device_ops': tr['device_ops'],
                            'idle_gaps': tr['idle_gaps']}
    out['checks'] = checks
    return out


def device_block(torch, dev, n: int = 1) -> dict:
    """The result's `device`: the card's name, the cards used and the
    peak of allocated memory."""
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': n,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': n,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(dev))}
