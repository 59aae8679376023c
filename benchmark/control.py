"""The upper readings that the limits of `correct` are set from, on the
card:

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ...
        [--modes control half] [--out F.jsonl]

For each seed and mode the reference, changed as the mode says, stands
in the program's place, and the cell's check judges what it produced
against the plain reference, at the cell's own sizes; no program is
built. The modes:
  * control: the reference with both operands of every MLP product in
    fp8 (e4m3, a scale per tensor), a precision below the bfloat16 that
    the configurations state;
  * half (training): a fault, the reference on half of each batch's rays
    with the mean taken over those.
A training cell's second dispatch starts from the plain reference's
state after the first, where a run's starts from the program's after its
window. A render cell's check keeps the run's sample of requests. The
lower readings are the program's own, which every run of
`benchmark/run.py` prints on standard error. Prints one JSON line a seed
and mode, then the smallest reading of each number by mode. The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path = [str(ROOT)] + [x for x in sys.path
                          if Path(x or '.').resolve() != ROOT / 'benchmark']

from benchmark import harness, scene  # noqa: E402

MODES = {'control': {'lowp': True}, 'half': {'half_batch': True}}


def train_readings(cell, seed: int, mode: str, dev) -> dict:
    """The train check of the first two dispatches drawn from the seed,
    with the reference in `mode` in the program's place."""
    import torch
    from benchmark.drivers import train
    tr, tc = cell.traffic, cell.config['train_config']
    sk, cyls = train.inputs(cell)
    params = scene.weights(cell.config, tr['n_frames'], seed, dev)
    pool = scene.train_batches(sk, cyls, 2, tr['unroll'], tc['N_rand'],
                               tc['N_sample_images'], tr['camera_offset'],
                               tr['target_sigma'], seed)
    g0 = torch.Generator(device=dev).manual_seed(
        scene.seed64(seed)).get_state()
    n = tr['unroll']
    _, plain, gen = train.reference_run(cell, sk, scene.clone_tree(params),
                                        pool[0], g0, dev, n)
    start, g1 = plain.state(), gen.get_state()
    del plain
    cases = []
    for batch, gs, st in ((pool[0], g0, None), (pool[1], g1, start)):
        steps, _, _ = train.reference_run(cell, sk, scene.clone_tree(params),
                                          batch, gs, dev, n, start=st,
                                          **MODES[mode])
        cases.append({'batch': batch, 'gen_state': gs, 'start': st,
                      'prog': train.readings_of(steps)})
    return train.check(cell, sk, params, dev, *cases)


def render_readings(cell, seed: int, mode: str, dev) -> dict:
    """The render check of the requests a run keeps, rendered by the
    reference in fp8."""
    import numpy as np
    from benchmark.drivers import render
    from benchmark.drivers.train import model_of
    from benchmark.reference import anerf as ref
    if mode != 'control':
        raise SystemExit(f'a render cell has no mode {mode!r}')
    p = render.plan(cell, seed, dev)
    sk, kept = p['sk'], {}
    for i in sorted(p['sample']):
        frame = p['views'][i][0]
        img = ref.render_image(p['params'], model_of(cell.config),
                               sk['kp3d'][frame], sk['skts'][frame], frame,
                               p['cams'][i], p['H'], p['W'], p['focal'],
                               p['chunk'], dev, lowp=True)
        kept[i] = dict(img, bboxes=np.stack(img['box']))
    return render.check(cell, sk, p['params'], p['views'], p['cams'], kept,
                        dev, p['H'], p['W'], p['focal'], p['chunk'])


def readings(cell, seeds, modes, device='cuda', out=None):
    """[{'seed', 'mode', 'readings', 'seconds'}] of every seed and mode."""
    import torch
    dev = torch.device(device)
    of = {'train': train_readings, 'render': render_readings}[
        cell.traffic['kind']]
    rows = []
    for seed in seeds:
        for mode in modes:
            t = time.perf_counter()
            row = {'seed': seed, 'mode': mode,
                   'readings': of(cell, seed, mode, dev),
                   'seconds': time.perf_counter() - t}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, 'a') as f:
                    f.write(line + '\n')
    return rows


def summary(rows):
    """{number: {'<mode>_min': the smallest reading}}."""
    out = {}
    for row in rows:
        for k, v in row['readings'].items():
            d = out.setdefault(k, {})
            key = f'{row["mode"]}_min'
            d[key] = min(d.get(key, v), v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--modes', nargs='+', default=['control'],
                   choices=sorted(MODES))
    p.add_argument('--out', default=None)
    a = p.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    spec = harness.load_json(ROOT / 'BENCHMARK.json')
    cell = harness.load_cell(spec, a.workload)
    rows = readings(cell, a.seeds, a.modes, out=a.out)
    print(json.dumps({'summary': summary(rows)}), flush=True)


if __name__ == '__main__':
    main()
