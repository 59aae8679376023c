"""The traced window: torch.profiler over a few dispatches or requests,
reduced to what the per-layer readers need.

The trace is exported as Chrome JSON under TMPDIR and read back:
  * device activity: every kernel, copy and set on the card, with its
    time and the operation that launched it;
  * attribution to K1 and K2: a kernel whose launch (its correlation id)
    lies inside the autograd Function `FusedApply` is K1, inside its
    backward `FusedApplyBackward` K2; a kernel without such a range (the
    render path's no-grad calls) goes by its name (`kernel_owner`);
  * busy seconds: the union of the device activity inside the window;
  * the breakdown: the device operations that took most time, and the
    idle gaps by the benchmark span and the innermost host operation
    open on the main thread at the time.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import threading
from typing import Dict, List, Optional

#: kernels of K2 (the backward and the forward it recomputes, K1 with
#: SAVE) and of K1, by name, on the single kernel and the layered route
K2_NAMES = ('heads_bwd_kernel', 'bwd_layer_kernel', 'reduce_chunks_kernel',
            'pe_transform_bwd_kernel', 'phase_a_act_kernel')
K1_NAMES = ('k1_sm90_kernel', 'phase_a_rows_kernel', 'layer_gemm_kernel',
            'heads_kernel')
_SAVE = re.compile(r'k1_sm90_kernel<\s*\d+\s*,\s*true')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def kernel_owner(name: str) -> Optional[str]:
    """'K1', 'K2' or None by a kernel's name."""
    if any(k in name for k in K2_NAMES) or _SAVE.search(name):
        return 'K2'
    if any(k in name for k in K1_NAMES):
        return 'K1'
    return None


def _range_owner(name: str) -> Optional[str]:
    if 'FusedApplyBackward' in name:
        return 'K2'
    if name == 'FusedApply' or name.endswith(': FusedApply') \
            or name.startswith('FusedApply.'):
        return 'K1'
    return None


class _Ranges:
    """Host ranges of one thread, for 'which of them holds time t'."""

    def __init__(self, evs):
        self.evs = sorted(evs, key=lambda e: e['ts'])
        self.starts = [e['ts'] for e in self.evs]
        self.longest = max((e['dur'] for e in self.evs), default=0.0)

    def innermost(self, t: float) -> Optional[dict]:
        """The range open at t that opened last (the innermost one)."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.starts[j] >= t - self.longest:
            e = self.evs[j]
            if e['ts'] + e['dur'] >= t:
                return e
            j -= 1
        return None


def capture(fn, label: str = 'window'):
    """Run fn() under torch.profiler (CPU and CUDA) inside a benchmark
    span `bench.<label>`; returns (fn's result, the parsed trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_gpu = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    with profile(activities=acts) as prof:
        with record_function(f'bench.{label}'):
            out = fn()
        if on_gpu:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix='bench_trace_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])
    return out, reduce_trace(events, f'bench.{label}',
                             threading.get_native_id())


def reduce_trace(events: List[dict], window: str,
                 main_tid: Optional[int] = None) -> dict:
    """{'device': [(name, start us, dur us, owner)], 'busy_s', 'window_s',
    'rules': {'range': n, 'name': n}, 'device_ops', 'idle_gaps'} of a
    Chrome trace whose window is the host span named `window`."""
    xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    host = [e for e in xs if e.get('cat') in ('cpu_op', 'user_annotation',
                                               'python_function')]
    win = [e for e in host if e.get('name') == window]
    if not win:
        raise RuntimeError(f'trace: no span {window!r}')
    w0 = win[0]['ts']
    w1 = w0 + win[0]['dur']
    if main_tid is None or not any(e.get('tid') == main_tid for e in win):
        main_tid = win[0].get('tid')
    launches = {}
    for e in xs:
        if e.get('cat') in ('cuda_runtime', 'cuda_driver'):
            c = e.get('args', {}).get('correlation')
            if c is not None:
                launches[c] = e
    by_tid = collections.defaultdict(list)
    for e in host:
        if _range_owner(e.get('name', '')) is not None:
            by_tid[e.get('tid')].append(e)
    owned = {tid: _Ranges(v) for tid, v in by_tid.items()}

    device, rules = [], collections.Counter()
    for e in xs:
        if e.get('cat') not in DEVICE_CATS:
            continue
        name = e.get('name', '')
        owner, rule = None, 'name'
        launch = launches.get(e.get('args', {}).get('correlation'))
        if launch is not None and launch.get('tid') in owned:
            held = owned[launch['tid']].innermost(launch['ts'])
            if held is not None:
                owner, rule = _range_owner(held['name']), 'range'
        if owner is None:
            owner = kernel_owner(name) if e.get('cat') == 'kernel' else None
            rule = 'name'
        rules[rule] += 1
        device.append((name, float(e['ts']), float(e['dur']), owner))

    # the union of device activity inside the window, and its gaps
    iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _ in device
                if s < w1 and s + d > w0)
    busy, gaps, cur0, cur1 = 0.0, [], None, None
    last_end = w0
    for a, b in iv:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > last_end:
                gaps.append((last_end, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        last_end = max(last_end, b)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last_end:
        gaps.append((last_end, w1))

    on_main = [e for e in host if e.get('tid') == main_tid]
    spans = _Ranges([e for e in on_main if e['name'].startswith('bench.')])
    # host operations, less the profiler's own span over the whole window
    ops_main = _Ranges([e for e in on_main
                        if not e['name'].startswith('bench.')
                        and e['dur'] < 0.1 * (w1 - w0)])
    idle = collections.Counter()
    for a, b in gaps:
        span, op = spans.innermost(0.5 * (a + b)), \
            ops_main.innermost(0.5 * (a + b))
        label = (span['name'] if span else 'outside') + ' > ' + \
            (op['name'] if op else 'python')
        idle[label[:160]] += (b - a) * 1e-6
    ops = collections.Counter()
    for name, _, d, _ in device:
        ops[name[:160]] += d * 1e-6
    return {'device': device, 'busy_s': busy * 1e-6,
            'window_s': (w1 - w0) * 1e-6, 'rules': dict(rules),
            'device_ops': [[k, v] for k, v in ops.most_common(10)],
            'idle_gaps': [[k, v] for k, v in idle.most_common(10)]}


def owner_seconds(tr: dict) -> Dict[Optional[str], float]:
    """Device seconds by owner ('K1', 'K2', None for the rest)."""
    out: Dict[Optional[str], float] = collections.defaultdict(float)
    for _, _, d, owner in tr['device']:
        out[owner] += d * 1e-6
    return dict(out)
