"""Host spans: named intervals of the host's time at the layer boundaries
of the train step and the render request.

    from anerf_torch.utils import trace
    trace.enable()
    with trace.span('anerf.train.step', n=rays):
        ...
    trace.disable()
    by_name = trace.summary(trace.take())
    # {name: {'count', 'total_ms', 'self_ms', 'n'}}

Off (the default) `span` returns one shared object that does nothing: a
span then costs a read of a module global, with no allocation, no clock
read and no torch call. On, each span appends a `Span` record when it
closes, its times read by `time.perf_counter_ns()`; `take()` hands the
records over and clears them.

The spans under one root (a span opened where no span is open: one
dispatch, one request) share the root's id. A span opened on a thread
with no span open takes as parent the innermost span open on the root's
thread: on CUDA, autograd runs FusedApply's backward on its device
thread, under the step's `anerf.train.backward`. A span's self time is
its duration less the union of the intervals its children cover, on
whatever thread. While a torch.profiler records, an open span also opens
a `record_function` range of its name, so it sits in the profiler's
trace on the same clock as the device's events.

`n` carries the work count at the span's boundary (rays, points); `add`
raises it once the count is known. Every name starts with `anerf.`.

The spans (one a layer boundary):
  anerf.train.dispatch  train/trainer.py, the scanned step           rays
  anerf.train.step      one train step                              rays
  anerf.train.forward   the step's loss_fn: FK, raycaster, losses
  anerf.train.backward  the step's torch.autograd.grad
  anerf.train.adam      both optimizer updates, grad norms, unflattens
  anerf.loop.upload     train/loop.py:upload_batch
  anerf.loop.wait       train/loop.py, the loader's next()
  anerf.fused.pack      kernels/fused_render.py:pack_render_params
  anerf.fused.k1        fused_encode_mlp_pts                        points
  anerf.fused.k2        FusedApply.backward: K2, the leaf gradients points
  anerf.render.request  render/render_path.py:render_path           box rays
  anerf.render.bucket   one render_rays call of the bucket loop     rays
  anerf.render.fetch    render_one_pose's copy to the host
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch

#: one closed span; `parent` and `root` are span ids (`parent` None for
#: a root), t0 / t1 nanoseconds of time.perf_counter_ns()
Span = collections.namedtuple('Span', 'id name tid parent root t0 t1 n')

_on = False
_records: List[tuple] = []          # Span's fields, made Spans by take()
_stacks: Dict[int, list] = {}       # thread -> its open spans, innermost last
_root = None                        # the open root, if any
_ids = itertools.count(1)


class _Off:
    """The span of a disabled trace."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, n: int) -> None:
        pass


_OFF = _Off()


class _Open:
    """A recording span, from its `with` to its end."""
    __slots__ = ('id', 'name', 'n', 'tid', 'parent', 'root', 't0', 'range')

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def add(self, n: int) -> None:
        self.n += n

    def __enter__(self):
        global _root
        self.id = next(_ids)
        self.tid = threading.get_ident()
        stack = _stacks.setdefault(self.tid, [])
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        elif _root is not None:
            self.parent, self.root = _stacks[_root.tid][-1].id, _root.id
        else:
            self.parent, self.root = None, self.id
            _root = self
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _root
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _stacks[self.tid].pop()
        if _root is self:
            _root = None
        _records.append((self.id, self.name, self.tid, self.parent,
                         self.root, self.t0, t1, self.n))
        return False


def span(name: str, n: int = 0):
    """A context manager timing its block as `name` (with `n` the work
    count) while the trace is on; the shared no-op object while off."""
    if not _on:
        return _OFF
    return _Open(name, n)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans still open record when they close."""
    global _on
    _on = False


def take() -> List[Span]:
    """The records of the spans closed since the last take, cleared."""
    global _records
    out, _records = _records, []
    return [Span._make(r) for r in out]


def _covered(intervals: Iterable, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] that the union of `intervals` covers."""
    total, end = 0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def summary(records: Iterable[Span]) -> Dict[str, Dict[str, float]]:
    """By name: 'count', 'total_ms', 'self_ms' (the duration less the
    union of the children's intervals, on any thread) and 'n' summed."""
    records = list(records)
    kids: Dict[Optional[int], list] = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.parent].append((r.t0, r.t1))
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        d = r.t1 - r.t0
        s = out.setdefault(r.name, {'count': 0, 'total_ms': 0.0,
                                    'self_ms': 0.0, 'n': 0})
        s['count'] += 1
        s['total_ms'] += d * 1e-6
        s['self_ms'] += (d - _covered(kids.get(r.id, ()), r.t0, r.t1)) \
            * 1e-6
        s['n'] += r.n
    return out
