"""The per-kernel device-time breakdown of one bench train-step config
(torch port of tools/step_trace.py):

    python -m anerf_torch.tools.step_trace [--fused] [--fast_grads]
        [--cull 0.125] [--dispatches 3] [--top 40] [--json out.json]
        [--device cuda]

builds the scanned step `anerf_torch.tools.bench` measures (`build`),
runs 3 warm dispatches, then `--dispatches` dispatches under
torch.profiler, and prints the device time grouped by kernel name, the
largest first: the wall time, each kernel's milliseconds, launches and
share of the device time, the device-busy total and the idle share of
the window. K1 (`k1_sm90_kernel<0, false, 0>`), K2's recompute (K1's
kernel with SAVE, `k1_sm90_kernel<0, true, 0>`) and K2's launches
(`heads_bwd_kernel`, then one `bwd_layer_kernel` a layer, each row named
by its place after the call's heads launch, `reduce_chunks_kernel`,
`pe_transform_bwd_kernel`) show up by name. `--json` also writes the
rows. On the CPU (`--device cpu`, for tests) the rows are the CPU ops'
self times. It runs on the GPU and raises without one.

`kernel_rows` is the one parser of a profile; chip_smoke.py's profile
reports use it too.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

#: K2's layer launches share one kernel name: each is named by its place
#: after the call's first launch
K2_SPLIT = ('heads_bwd_kernel', 'bwd_layer_kernel')


def kernel_rows(prof, lane='cuda', split=K2_SPLIT):
    """[(microseconds, launches, name)] of a torch.profiler window, the
    largest first: device kernels by their self device time on 'cuda'
    (an aten op's device time is its kernels', which are rows of their
    own), CPU ops by their self time on 'cpu'. With `split` = (first,
    each), every launch of `each` after a launch of `first` is named by
    its place there (` [2 after first]`)."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if lane == 'cuda' else DeviceType.CPU
    totals, counts = collections.Counter(), collections.Counter()
    place = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != want:
            continue
        if lane == 'cuda':
            us = (e.self_device_time_total
                  if hasattr(e, 'self_device_time_total')
                  else e.self_cuda_time_total)     # torch < 2.4
        else:
            us = e.self_cpu_time_total
        if us <= 0:
            continue
        key = e.key
        if split is not None:
            if split[0] in key:
                place = 0
            elif split[1] in key:
                place += 1
                key = f'{key} [{place} after {split[0]}]'
        totals[key] += us
        counts[key] += 1
    return sorted(((us, counts[k], k) for k, us in totals.items()),
                  reverse=True)


def capture(build_kw, n_dispatch=3, warmup=3, device='cuda'):
    """`build(**build_kw)`, `warmup` dispatches, then `n_dispatch` under
    the profiler. Returns (profile, wall seconds, rays, lane)."""
    from torch.profiler import ProfilerActivity, profile

    from .bench import _generator, _sync, build

    state, step_fn, stacks, rpd = build(device=device, **build_kw)
    dev = stacks[0]['rays'].device
    k = 0
    for _ in range(warmup):
        state, _ = step_fn(state, stacks[k % 2], _generator(dev, k))
        k += 1
    _sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            state, _ = step_fn(state, stacks[k % 2], _generator(dev, k))
            k += 1
        _sync(dev)
        wall = time.perf_counter() - t0
    return prof, wall, rpd * n_dispatch, dev.type


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--fused', action='store_true')
    p.add_argument('--fast_grads', action='store_true')
    p.add_argument('--cull', type=float, default=0.0)
    p.add_argument('--dispatches', type=int, default=3)
    p.add_argument('--top', type=int, default=40)
    p.add_argument('--json', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda')
    a = p.parse_args(argv)

    from .. import resolve_device
    from .bench import device_line

    resolve_device(a.device)
    build_kw = dict(fused_kernel=a.fused, fast_grads=a.fast_grads,
                    cull_ratio=a.cull)
    prof, wall, rays, lane = capture(build_kw, n_dispatch=a.dispatches,
                                     device=a.device)
    rows = kernel_rows(prof, lane)
    busy = sum(us for us, _, _ in rows)
    print(f'config: {build_kw}; device: {device_line(a.device)}')
    print(f'wall: {wall:.3f}s for {a.dispatches} dispatches '
          f'({rays / wall:,.0f} rays/s) under the profiler')
    out = []
    for us, n, key in rows[:a.top]:
        share = us / max(busy, 1)
        out.append({'lane': lane, 'op': key, 'ms': us / 1000.0, 'n': n,
                    'lane_share': round(share, 4)})
        print(f'{us / 1000.0:>10.3f} ms  {n:>6}x {share:>7.2%}  [{lane}] '
              f'{key[:120]}')
    idle = 1.0 - busy / 1e6 / wall
    print(f'lane total {busy / 1000.0:>10.3f} ms  [{lane}]; idle share '
          f'{idle:.3f}')
    result = {'config': build_kw, 'device': device_line(a.device),
              'wall_s': wall, 'rays_per_s': rays / wall,
              'busy_ms': busy / 1000.0, 'idle_share': idle, 'rows': out}
    if a.json:
        with open(a.json, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    main()
