"""The port's host spans (anerf_torch/utils/trace.py): off they are one
shared object and record nothing; on they nest by thread, share their
root's id, carry their work count, take a parent across threads, and
sit in a CPU torch.profiler's Chrome trace. Self time against a
hand-built interval set; the benchmark's reduction of a Chrome trace by
span (benchmark/spans.py) on a synthetic event list."""
import json
import threading

import pytest
import torch

from anerf_torch.utils import trace
from benchmark import spans as bspans

MS = 1_000_000          # nanoseconds


@pytest.fixture
def on():
    trace.take()
    trace.enable()
    yield
    trace.disable()
    trace.take()


def test_off_spans_are_one_shared_object_and_record_nothing():
    trace.take()
    a, b = trace.span('anerf.a', 3), trace.span('anerf.b')
    assert a is b
    with a as inside:
        inside.add(5)
        with b:
            pass
    assert trace.take() == []


def test_spans_nest_share_their_root_and_carry_n(on):
    with trace.span('anerf.root', 4):
        with trace.span('anerf.mid'):
            with trace.span('anerf.leaf', 2) as leaf:
                leaf.add(3)
        with trace.span('anerf.mid2'):
            pass
    with trace.span('anerf.next'):
        pass
    r = {s.name: s for s in trace.take()}
    root = r['anerf.root']
    assert root.parent is None and root.root == root.id and root.n == 4
    assert r['anerf.mid'].parent == root.id
    assert r['anerf.mid2'].parent == root.id
    assert r['anerf.leaf'].parent == r['anerf.mid'].id
    assert r['anerf.leaf'].n == 5
    assert {r[k].root for k in ('anerf.mid', 'anerf.mid2', 'anerf.leaf')} \
        == {root.id}
    nxt = r['anerf.next']
    assert nxt.parent is None and nxt.root == nxt.id != root.id
    assert all(s.t1 >= s.t0 for s in r.values())


def test_a_span_on_another_thread_takes_the_root_threads_innermost(on):
    with trace.span('anerf.root'):
        with trace.span('anerf.backward'):
            t = threading.Thread(target=lambda: trace.span(
                'anerf.engine').__enter__().__exit__(None, None, None))
            t.start()
            t.join()
    r = {s.name: s for s in trace.take()}
    eng = r['anerf.engine']
    assert eng.tid != r['anerf.backward'].tid
    assert eng.parent == r['anerf.backward'].id
    assert eng.root == r['anerf.root'].id


def test_self_time_is_duration_less_the_union_of_children():
    S = trace.Span
    recs = [S(1, 'anerf.p', 1, None, 1, 0, 100 * MS, 0),
            S(2, 'anerf.c', 1, 1, 1, 10 * MS, 30 * MS, 1),
            S(3, 'anerf.c', 1, 1, 1, 20 * MS, 40 * MS, 1),
            S(4, 'anerf.t', 2, 1, 1, 35 * MS, 60 * MS, 0),   # another thread
            S(5, 'anerf.t', 2, 1, 1, 90 * MS, 120 * MS, 0),  # past its end
            S(6, 'anerf.g', 1, 2, 1, 12 * MS, 18 * MS, 0)]
    s = trace.summary(recs)
    # covered: [10, 60] and [90, 100]
    assert s['anerf.p'] == pytest.approx(
        {'count': 1, 'total_ms': 100.0, 'self_ms': 40.0, 'n': 0})
    assert s['anerf.c'] == pytest.approx(
        {'count': 2, 'total_ms': 40.0, 'self_ms': 34.0, 'n': 2})
    assert s['anerf.t']['self_ms'] == pytest.approx(55.0)


def test_spans_sit_in_a_cpu_profilers_trace(on, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('anerf.train.step'):
            with trace.span('anerf.fused.k1', 8):
                torch.ones(8) * 2
            with trace.span('anerf.train.adam'):
                torch.ones(8) + 1
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get('traceEvents', events) \
        if isinstance(events, dict) else events
    names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    recs = trace.take()
    assert len(recs) == 3
    assert {r.name for r in recs} <= names


def test_idle_by_span_names_the_innermost_anerf_span_or_none():
    def x(name, cat, ts, dur, tid=1):
        return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
                'tid': tid}
    events = [x('bench.window', 'user_annotation', 0, 1000),
              x('anerf.train.dispatch', 'user_annotation', 0, 500),
              x('anerf.train.forward', 'user_annotation', 100, 300),
              x('aten::mul', 'cpu_op', 180, 40),
              x('anerf.fused.k2', 'user_annotation', 650, 100, tid=2),
              x('other', 'user_annotation', 600, 300),
              x('k', 'kernel', 0, 150, tid=7),
              x('k', 'kernel', 250, 350, tid=7),
              x('k', 'gpu_memcpy', 800, 250, tid=8)]
    idle = bspans.idle_by_span(events, 'bench.window')
    assert idle == pytest.approx({'anerf.train.forward': 100e-6,
                                  'none': 200e-6})


def test_host_split_reads_each_layer():
    def sp(count, total, self_ms=None):
        return {'count': count, 'total_ms': total,
                'self_ms': total if self_ms is None else self_ms, 'n': 0}
    train = {'anerf.train.step': sp(2, 80.0, 4.0),
             'anerf.train.forward': sp(2, 30.0, 20.0),
             'anerf.train.backward': sp(2, 36.0, 10.0),
             'anerf.train.adam': sp(2, 6.0),
             'anerf.fused.pack': sp(4, 2.0), 'anerf.fused.k1': sp(4, 8.0),
             'anerf.fused.k2': sp(4, 26.0), 'anerf.loop.upload': sp(1, 1.0)}
    assert bspans.host_split(train, 'train') == pytest.approx({
        'host_step_ms.train': 40.0, 'host_raybatch_ms.train': 10.0,
        'host_autograd_ms.train': 5.0, 'host_kernels_ms.train': 18.0,
        'host_adam_ms.train': 3.0, 'upload_ms.train': 0.5,
        'step_self_share': 0.05})
    render = {'anerf.render.request': sp(2, 100.0),
              'anerf.render.bucket': sp(20, 60.0),
              'anerf.render.fetch': sp(2, 30.0)}
    assert bspans.host_split(render, 'render') == pytest.approx({
        'host_request_ms.render': 5.0, 'host_bucket_ms.render': 3.0,
        'device_wait_ms.render': 15.0})
