"""The general driver of render mixes (`"kind": "render"`): one client
sends requests one after another (a closed loop), each one image of one
frame through the port's `render/render_path.py:render_path`, as the
render server serves them on one thread.

The mix holds a fixed set of (frame, angle) views (`scene.request_set`);
each pass over the set takes them in an order drawn from the seed, so
every seed renders the same boxes. Set-up warms up on the set's largest
and smallest boxes. The window issues requests until `--seconds` have
passed; a request's latency runs from its issue to its images on the
host, and the window ends with the last request begun inside it.

The check renders a sample of the requests again on the plain
reference: the first of the largest box and of `check_requests` more
views drawn from the seed (served after the window, uncounted, where the
window ends before the pass that holds them), each compared pixel by
pixel (rgb over white, acc, disp) and by its box.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from .. import counts, devtrace, harness, scene
from ..reference import anerf as ref
from .train import model_of


def plan(cell, seed: int, dev) -> dict:
    """A run's inputs, from the seed: the skeleton, the weights, the mix's
    views with their cameras and box sizes, the requests the check keeps
    (the largest box and `check_requests` more) and the generator that
    then orders each pass."""
    tr = cell.traffic
    sk = scene.skeleton(tr['n_frames'])
    H, W = tr['H'], tr['W']
    focal = tr['focal_ratio'] * W
    views = scene.request_set(tr)
    cams = [scene.request_camera(sk, f, a, tr['camera_offset'])
            for f, a in views]
    sizes = [scene.box_rays(sk, f, c, H, W, focal)
             for (f, _), c in zip(views, cams)]
    rng = np.random.default_rng(scene.seed64(seed))
    largest = int(np.argmax(sizes))
    others = [i for i in range(len(views)) if i != largest]
    sample = {largest} | set(rng.choice(others, tr['check_requests'],
                                        replace=False).tolist())
    return {'sk': sk, 'H': H, 'W': W, 'focal': focal, 'views': views,
            'cams': cams, 'sizes': sizes, 'sample': sample, 'rng': rng,
            'params': scene.weights(cell.config, tr['n_frames'], seed, dev),
            'chunk': cell.config['train_config']['chunk']}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, render_wrapper=None) -> dict:
    """One run (harness.run_cell). `render_wrapper` wraps render_path
    (the tests' faults)."""
    from anerf_torch import resolve_device
    from anerf_torch.config import TrainConfig
    from anerf_torch.render.factory import build_render_config
    from anerf_torch.render.render_path import render_path
    from anerf_torch.skeleton import SMPLSkeleton

    dev = resolve_device(device)
    on_gpu = dev.type == 'cuda'
    tc, tr = cell.config['train_config'], cell.traffic
    args = TrainConfig(**tc)
    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': tr['n_frames']})
    p = plan(cell, seed, dev)
    sk, params, views, cams, sizes = (p['sk'], p['params'], p['views'],
                                      p['cams'], p['sizes'])
    H, W, focal, sample, rng = p['H'], p['W'], p['focal'], p['sample'], \
        p['rng']
    ref_params = scene.clone_tree(params)
    largest = int(np.argmax(sizes))
    draw = render_path if render_wrapper is None else \
        render_wrapper(render_path)

    def request(i):
        frame = views[i][0]
        return draw(params, cfg, cams[i][None], (H, W, focal),
                    sk['kp3d'][frame][None], sk['skts'][frame][None],
                    sk['bones'][frame][None], cam_idxs=np.array([frame]),
                    tau=2000.0, chunk=args.chunk, ext_scale=tc['ext_scale'],
                    white_bkgd=True, use_framecode_idx=True)

    # set-up: the largest and the smallest box
    for i in (largest, int(np.argmin(sizes))):
        request(i)
    if on_gpu:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    span = (torch.profiler.record_function if trace
            else (lambda name: contextlib.nullcontext()))
    kept, lat, box = {}, [], []

    def order():
        while True:
            yield from rng.permutation(len(views)).tolist()

    it = order()

    def one(count=True):
        i = next(it)
        t = time.perf_counter()
        with span('bench.request'):
            out = request(i)
        if count:
            lat.append(time.perf_counter() - t)
            tl, br = out['bboxes'][0]
            box.append(int((br[0] - tl[0]) * (br[1] - tl[1])))
        if i in sample and i not in kept:
            kept[i] = {k: np.array(out[k][0]) for k in
                       ('rgbs', 'accs', 'disps', 'bboxes')}

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one()
    dt = time.perf_counter() - t0
    n_req = len(lat)
    # a window too short for the pass that holds the sample: the rest of
    # the pass, uncounted
    while not sample <= set(kept):
        one(count=False)
    e2e = {'render_box_rays_per_s': sum(box) / dt,
           'render_latency_p90_s': float(np.percentile(lat, 90))
           if lat else float('nan'), 'setup_s': setup_s,
           'requests': n_req, 'window_s': dt}
    ctx = None
    if trace:
        # after the window, a pass of requests under the profiler
        def window():
            for _ in range(tr['trace_requests']):
                one()
        _, tra = devtrace.capture(window)
        ctx = _reader_ctx(cell, tra, box[n_req:], args.chunk)
        ctx['window_model_flop_per_s'] = counts.model_flop_per_ray(
            cell.config, False) * sum(box[:n_req]) / dt
    dev_info = harness.device_block(torch, dev)

    del params, p
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    readings = check(cell, sk, ref_params, views, cams, kept, dev, H, W,
                     focal, args.chunk)
    return {'end_to_end': e2e, 'readings': readings, 'ctx': ctx,
            'attempted': n_req, 'failed': 0, 'device': dev_info}


def check(cell, sk, params, views, cams, kept, dev, H, W, focal, chunk
          ) -> dict:
    """The worst gaps over the kept requests between what the program
    returned ({request: 'rgbs', 'accs', 'disps', 'bboxes'}) and the
    reference's image: the largest and the mean absolute gap of rgb, acc
    and disp over the box, and whether the boxes differ."""
    ref.strict_f32()
    model = model_of(cell.config)
    out = {f'{q}_{s}_gap': 0.0 for q in ('rgb', 'acc', 'disp')
           for s in ('max', 'mean')}
    out['box_mismatch'] = 0.0
    if not kept:
        return {k: float('nan') for k in out}
    for i, got in sorted(kept.items()):
        frame = views[i][0]
        want = ref.render_image(params, model, sk['kp3d'][frame],
                                sk['skts'][frame], frame, cams[i], H, W,
                                focal, chunk, dev)
        tl, br = want['box']
        if not np.array_equal(np.asarray(got['bboxes']),
                              np.stack([tl, br])):
            out['box_mismatch'] = 1.0
        ys, xs = slice(tl[1], br[1]), slice(tl[0], br[0])
        for q, key in (('rgb', 'rgbs'), ('acc', 'accs'), ('disp', 'disps')):
            g = np.abs(np.asarray(got[key], np.float64)[ys, xs]
                       - np.asarray(want[key], np.float64)[ys, xs])
            if g.size == 0:
                continue
            if not np.isfinite(g).all():
                out[f'{q}_max_gap'] = out[f'{q}_mean_gap'] = float('inf')
                continue
            out[f'{q}_max_gap'] = max(out[f'{q}_max_gap'], float(g.max()))
            out[f'{q}_mean_gap'] = max(out[f'{q}_mean_gap'], float(g.mean()))
    out['requests_checked'] = float(len(kept))
    return out


def _reader_ctx(cell, tra: dict, box, chunk: int) -> dict:
    """What the per-layer readers of a traced render window read."""
    net = counts.net_of(cell.config)
    buckets = sum(-(-n // chunk) for n in box if n)
    k1 = sum(counts.k1_bound_s(net, chunk, S)
             for S, _ in counts.passes(cell.config))
    return {'trace': tra, 'owner_s': devtrace.owner_seconds(tra),
            'requests': len(box), 'buckets': buckets,
            'k1_bound_s': k1 * buckets}
