"""The port's host spans (anerf_torch/utils/trace.py) in one run of a
cell:

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>
        [--repeats 3]

from the root of a checkout. It runs the cell as `run.py --trace 1`
does, with the traced window's capture (`devtrace.capture`) replaced in
this process by one that runs that window
  * once under torch.profiler with the spans on, so the Chrome trace
    holds them beside the device's activity (`idle_by_span`, and the
    breakdown's idle gaps name the span where no operation is open);
  * then `--repeats` times with both off and with the spans on alone,
    in turns (off, on, on, off, ...), each timed (their rates, the cost
    of the spans when on) and the spans-only windows' records summed
    (`trace.summary`).
It prints one JSON line: `correct` (the cell's own check), the timed
window's rate, the rates of the spans-off and spans-only windows, the
host split by layer under the names of the metrics it is for
(`host_split`), `idle_by_span`, the span summary, the breakdown's idle
gaps and a span's host cost off and on (`span_cost`, 10^6 calls).
It exits non-zero, printing no result, without a CUDA card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path = [str(ROOT)] + [x for x in sys.path
                          if Path(x or '.').resolve() != ROOT / 'benchmark']

from benchmark import devtrace, harness  # noqa: E402


def idle_by_span(events: List[dict], window: str) -> Dict[str, float]:
    """Idle seconds of the card inside the host span `window` of a Chrome
    trace, by the innermost `anerf.*` span open on the window's thread
    at each gap's midpoint ('none' where no such span is open)."""
    xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    win = next(e for e in xs if e.get('name') == window
               and e.get('cat') == 'user_annotation')
    w0, w1 = win['ts'], win['ts'] + win['dur']
    iv = sorted((max(e['ts'], w0), min(e['ts'] + e['dur'], w1)) for e in xs
                if e.get('cat') in devtrace.DEVICE_CATS
                and e['ts'] < w1 and e['ts'] + e['dur'] > w0)
    gaps, end = [], w0
    for a, b in iv:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    spans = devtrace._Ranges([
        e for e in xs if e.get('cat') == 'user_annotation'
        and e.get('tid') == win.get('tid')
        and e.get('name', '').startswith('anerf.')])
    idle: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        held = spans.innermost(0.5 * (a + b))
        idle[held['name'] if held else 'none'] += (b - a) * 1e-6
    return dict(idle)


def host_split(s: Dict[str, dict], kind: str) -> Dict[str, float]:
    """The host's milliseconds by layer from a span summary of train
    dispatches or render requests, by the names of the metrics they are
    for; `step_self_share` is the part of a step outside its child
    spans."""
    def ms(name, key='total_ms'):
        return s.get(name, {}).get(key, 0.0)

    if kind == 'train':
        steps = s['anerf.train.step']['count']
        fused = sum(v['total_ms'] for k, v in s.items()
                    if k.startswith('anerf.fused.'))
        return {'host_step_ms.train': ms('anerf.train.step') / steps,
                'host_raybatch_ms.train':
                    ms('anerf.train.forward', 'self_ms') / steps,
                'host_autograd_ms.train':
                    ms('anerf.train.backward', 'self_ms') / steps,
                'host_kernels_ms.train': fused / steps,
                'host_adam_ms.train': ms('anerf.train.adam') / steps,
                'upload_ms.train': ms('anerf.loop.upload') / steps,
                'step_self_share': ms('anerf.train.step', 'self_ms')
                / ms('anerf.train.step')}
    req = s['anerf.render.request']
    inside = ms('anerf.render.bucket') + ms('anerf.render.fetch')
    return {'host_request_ms.render':
            (req['total_ms'] - inside) / req['count'],
            'host_bucket_ms.render': ms('anerf.render.bucket')
            / s['anerf.render.bucket']['count'],
            'device_wait_ms.render': ms('anerf.render.fetch') / req['count']}


def span_cost(calls: int, batch: int = 10 ** 4) -> Dict[str, float]:
    """Nanoseconds a `with trace.span(...)` block adds to a bare loop,
    with the spans off and on: the mean over `calls` calls, in loops of
    `batch` calls (about a window's spans) with the records taken
    between them, untimed."""
    from anerf_torch.utils import trace

    def loop(n: int, with_span: bool) -> int:
        t = time.perf_counter_ns()
        if with_span:
            for _ in range(n):
                with trace.span('anerf.cost', 1):
                    pass
        else:
            for _ in range(n):
                pass
        return time.perf_counter_ns() - t

    sizes = [batch] * (calls // batch) + (
        [calls % batch] if calls % batch else [])
    bare = off = on = 0
    for n in sizes:
        bare += loop(n, False)
        off += loop(n, True)
        trace.enable()
        try:
            on += loop(n, True)
        finally:
            trace.disable()
        trace.take()
    return {'off_ns': (off - bare) / calls, 'on_ns': (on - bare) / calls}


def _profiled(fn, window: str):
    """fn() under torch.profiler (CPU and CUDA) inside the host span
    `window`: (fn's result, the Chrome trace's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_gpu = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    with profile(activities=acts) as prof:
        with record_function(window):
            out = fn()
        if on_gpu:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix='spans_trace_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])
    return out, events


def run(cell: harness.Cell, seed: int, seconds: float, device: str = 'cuda',
        repeats: int = 3, calls: int = 10 ** 6,
        t_start: float | None = None) -> dict:
    """One run of `cell` with the spans measured (the module's doc)."""
    from anerf_torch.utils import trace

    kind = cell.traffic['kind']
    work = [0]              # rays, or box rays, issued so far

    def count_rays(step):
        def counted(state, batches, gen):
            work[0] += batches['rays'].shape[0] * batches['rays'].shape[1]
            return step(state, batches, gen)
        return counted

    def count_box_rays(draw):
        def counted(*a, **kw):
            out = draw(*a, **kw)
            for tl, br in out['bboxes']:
                work[0] += int((br[0] - tl[0]) * (br[1] - tl[1]))
            return out
        return counted

    def timed(fn) -> float:
        w, t = work[0], time.perf_counter()
        fn()
        return (work[0] - w) / (time.perf_counter() - t)

    found: dict = {}

    def capture(fn, label='window'):
        window = f'bench.{label}'
        trace.enable()
        try:
            out, events = _profiled(fn, window)
        finally:
            trace.disable()
        trace.take()
        found['idle_by_span'] = idle_by_span(events, window)
        tr = devtrace.reduce_trace(events, window, threading.get_native_id())
        # the windows below run without the trace's events on the heap
        del events
        gc.collect()
        rates = {'off': [], 'on': []}
        records = []
        for i in range(repeats):
            # off then on, then on then off: no side always goes first
            for on in ((False, True), (True, False))[i % 2]:
                if on:
                    trace.enable()
                try:
                    rates['on' if on else 'off'].append(timed(fn))
                finally:
                    trace.disable()
            records += trace.take()
        found['rates'], found['spans'] = rates, trace.summary(records)
        found['idle_gaps'] = tr['idle_gaps']
        return out, tr

    wrap = ({'step_wrapper': count_rays} if kind == 'train'
            else {'render_wrapper': count_box_rays})
    t_start = time.perf_counter() if t_start is None else t_start
    captured, devtrace.capture = devtrace.capture, capture
    try:
        r = harness.driver(kind).run(cell, seed, seconds, True, device,
                                     t_start, **wrap)
    finally:
        devtrace.capture = captured
    rate = 'train_rays_per_s' if kind == 'train' else 'render_box_rays_per_s'
    ibs = found['idle_by_span']
    split = host_split(found['spans'], kind)
    split[f'idle_unspanned.{kind}'] = 100.0 * ibs.get('none', 0.0) / max(
        sum(ibs.values()), 1e-30)
    return {'correct': harness.is_correct(harness.judge(r['readings'],
                                                        cell.limits)),
            'rate_timed': r['end_to_end'][rate], 'rates': found['rates'],
            'host_split': split, 'idle_by_span': ibs,
            'idle_gaps': found['idle_gaps'], 'spans': found['spans'],
            'span_cost': span_cost(calls), 'device': r['device']}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--repeats', type=int, default=3)
    a = p.parse_args(argv)

    harness.set_cache_dirs(ROOT)
    cell = harness.load_cell(harness.load_json(ROOT / 'BENCHMARK.json'),
                             a.workload)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: the spans are measured on the card only',
              file=sys.stderr)
        return 3
    out = run(cell, a.seed, a.seconds, 'cuda', a.repeats, t_start=T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
