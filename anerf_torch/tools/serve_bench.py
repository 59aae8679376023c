"""The render server under concurrent clients (torch port of
tools/serve_bench.py):

    python -m anerf_torch.tools.serve_bench [--n_req 8] [--res 128]
        [--tcp_clients 1 4 8] [--tcp_req 16] [--fixture_seed 0]
        [--device cuda]

trains the flagship width (8 x 256, multires 7 / 4, 64 + 16 samples,
N_rand 1024; `MODEL`) for 100 steps on a 64-pose synthetic fixture (3
cameras at 64 x 64; its arrays in memory, data/schema.py:H5Arrays, so
no h5py is needed), loads it once into run_render.py's RenderSession
and times bullet-time requests (3 frames each at `--res`):

  * serial: `--n_req` requests, one render_path call each;
  * coalesced: the same requests in ONE render_path call (what the
    server's --coalesce does with queued requests);
  * with `--tcp_clients`, serve_tcp in a thread of this process and, for
    each count N, N client processes sending `--tcp_req` requests in all
    over their own connections: requests/s, mean / p50 / p95 latency and
    the server's own render seconds a request.

As in tools/serve_bench.py, every timed section owns a disjoint slice of
the 64 poses (0-7 warm, 8-15 serial and coalesced, 16 + 16 i for TCP
row i) with the same shapes as its warm-up. The last line is one JSON
object (`serve_coalesce_speedup` = serial / coalesced wall time). The
model is tools/serve_bench.py's, on the plain branch (no fused kernel).
It runs on the GPU and raises without one; `--device cpu` for tests.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

#: a TCP client: sends n bullet requests on its own connection, one at a
#: time, and prints [client latency, server render seconds] of each
CLIENT = (
    "import json,socket,sys,time\n"
    "port,rb,base,n=(int(a) for a in sys.argv[1:5])\n"
    "s=socket.create_connection(('127.0.0.1',port),timeout=600)\n"
    "f=s.makefile('r')\n"
    "lats=[]\n"
    "for j in range(n):\n"
    "    t0=time.perf_counter()\n"
    "    s.sendall((json.dumps({'render_type':'bullet',"
    "'selected_idxs':[rb+(base+j)%16],'runname':'tcp%d_%d'%(base,j),"
    "'no_save':True})+'\\n').encode())\n"
    "    r=json.loads(f.readline())\n"
    "    assert r['ok'],r\n"
    "    lats.append([time.perf_counter()-t0,"
    "r.get('render_seconds',-1.0)])\n"
    "print(json.dumps(lats))\n")


class _ReadyPipe:
    """Takes serve_tcp's ready line; holds the bound port."""

    def __init__(self):
        self.evt = threading.Event()
        self.port = None

    def write(self, s):
        for ln in s.strip().splitlines():
            try:
                self.port = json.loads(ln)['port']
                self.evt.set()
            except (ValueError, KeyError, TypeError):
                pass

    def flush(self):
        pass


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


#: the served model's TrainConfig fields (tools/serve_bench.py's)
MODEL = dict(
    netdepth=8, netwidth=256, multires=7, multires_views=4,
    N_samples=64, N_importance=16, N_rand=1024, N_sample_images=16,
    use_viewdirs=True, use_cutoff=True, cutoff_viewdir=True,
    cutoff_inputs=True, use_background=True, opt_framecode=True,
    ext_scale=0.001, raw_noise_std=1.0, chunk=1024 * 16,
    compute_dtype='bfloat16', scan_unroll=10)
N_ITERS = 100


def train_model(d: str, seed: int, device):
    """The served model: N_ITERS steps on the 64-pose fixture, its
    checkpoint at N_ITERS. Returns (experiment dir, dataset, source)."""
    from ..config import TrainConfig
    from ..data.fixtures import synthetic_data
    from ..data.schema import h5_arrays
    from ..data.surreal import SurrealDataset
    from ..train.loop import train

    # 64 poses: 8 warm, 8 serial / coalesced, 16 for each TCP row
    src = h5_arrays(synthetic_data(n_kps=64, n_cams=3, H=64, W=64,
                                   seed=seed),
                    path=os.path.join(d, 'syn_train_h5py.h5'))
    args = TrainConfig(
        expname='srv', basedir=d, dataset_type=('h5',), subject=(src.path,),
        i_weights=N_ITERS, i_testset=10**8, i_print=10**8, n_iters=N_ITERS,
        num_workers=0, no_reload=True, **MODEL)
    ds = SurrealDataset(src, N_samples=64, split='train')
    train(args, ds, n_iters=N_ITERS, device=device, save_images=False)
    return os.path.join(d, 'srv'), ds, src


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--n_req', type=int, default=8)
    p.add_argument('--res', type=int, default=128)
    p.add_argument('--tcp_clients', type=int, nargs='*', default=[],
                   help='also measure the TCP front-end at each given '
                        'concurrency: N client processes on one server '
                        '(e.g. --tcp_clients 1 4 8); at most 3 rows')
    p.add_argument('--tcp_req', type=int, default=16,
                   help='requests of each TCP row (at most 16: each row '
                        'owns a disjoint 16-pose slice)')
    p.add_argument('--fixture_seed', type=int, default=0)
    p.add_argument('--device', type=str, default='cuda')
    cli = p.parse_args(argv)
    if cli.n_req > 8:
        raise SystemExit('serial / coalesced section owns poses 8-15 only')
    if cli.tcp_req > 16 or len(cli.tcp_clients) > 3:
        raise SystemExit('TCP rows own disjoint 16-pose slices of the '
                         '64-pose fixture')

    import tempfile

    from .. import resolve_device
    from .. import run_render as rr
    from .bench import device_line

    dev = resolve_device(cli.device)
    d = os.path.join(tempfile.gettempdir(),
                     f'torch_serve_bench_s{cli.fixture_seed}')
    exp, ds, src = train_model(d, cli.fixture_seed, dev)

    r_args = rr.config_parser().parse_args([
        '--nerf_args', os.path.join(exp, 'args.txt'),
        '--ckptpath', os.path.join(exp, 'checkpoints'),
        '--render_res', str(cli.res), str(cli.res), '--dataset', 'surreal',
        '--entry', 'female', '--white_bkgd', '--render_type', 'bullet',
        '--mesh_res', '24', '--mesh_thres', '5.0',
        '--outputdir', os.path.join(d, 'render_out'), '--runname', 't',
        '--no_save'])
    sess = rr.RenderSession(r_args, device=dev, dataset=ds, h5=src)
    # bullet time of 3 frames around the selected pose
    sess.catalog = dict(sess.catalog, bullet=dict(
        sess.catalog['bullet'], selected_idxs=np.array([0]), n_bullet=3))

    def make_preps(pose_base: int, tag: str):
        out = []
        for i in range(cli.n_req):
            ns = argparse.Namespace(**vars(r_args))
            ns.selected_idxs = [pose_base + i % 8]
            ns.runname = f'{tag}{i}'
            out.append(sess.prepare(ns))
        return out

    warm_preps = make_preps(0, 'w')     # poses 0-7
    timed_preps = make_preps(8, 'c')    # poses 8-15
    # both call shapes once, untimed, on the warm poses
    for p_ in warm_preps:
        sess.render_prepared([p_])
    sess.render_prepared(warm_preps)

    t0 = time.perf_counter()
    for p_ in timed_preps:
        sess.render_prepared([p_])
    serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.render_prepared(timed_preps)
    coalesced = time.perf_counter() - t0

    result = {
        'metric': 'serve_coalesce_speedup',
        'n_requests': cli.n_req,
        'res': cli.res,
        'frames_per_request': 3,
        'serial_s_per_req': round(serial / cli.n_req, 3),
        'coalesced_s_per_req': round(coalesced / cli.n_req, 3),
        'value': round(serial / coalesced, 2),
        'unit': 'x (serial / coalesced wall time)',
        'device': device_line(cli.device),
    }
    if cli.tcp_clients:
        result['tcp'] = _tcp_rows(rr, r_args, sess, cli)
    print(json.dumps(result), flush=True)
    return result


def _tcp_rows(rr, r_args, sess, cli) -> dict:
    """serve_tcp on `sess` in a thread; each row's clients in processes."""
    import socket

    ready = _ReadyPipe()
    srv = threading.Thread(target=rr.serve_tcp, args=(r_args,),
                           kwargs={'port': 0, 'stdout': ready,
                                   'session': sess}, daemon=True)
    srv.start()
    if not ready.evt.wait(timeout=600):
        raise RuntimeError('the server never became ready')
    port = ready.port

    def run_clients(n_clients, per_client, row_base):
        procs = [subprocess.Popen(
            [sys.executable, '-c', CLIENT, str(port), str(row_base),
             str(i * per_client), str(per_client)],
            stdout=subprocess.PIPE, text=True)
            for i in range(n_clients)]
        t0 = time.perf_counter()
        lats, srv_s = [], []
        try:
            for pr in procs:
                out, _ = pr.communicate(timeout=1200)
                if pr.returncode != 0:
                    raise RuntimeError(f'a client exited {pr.returncode}')
                for client_lat, server_s in json.loads(out):
                    lats.append(client_lat)
                    srv_s.append(server_s)
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
        return time.perf_counter() - t0, lats, srv_s

    # warm-up on the warm poses: one at a time, then a burst of 4
    ws = socket.create_connection(('127.0.0.1', port), timeout=600)
    wf = ws.makefile('r')

    def send(i, tag):
        ws.sendall((json.dumps({'render_type': 'bullet',
                                'selected_idxs': [i], 'runname': f'{tag}{i}',
                                'no_save': True}) + '\n').encode())

    for i in range(2):
        send(i, 'w')
        json.loads(wf.readline())
    for i in range(2, 6):
        send(i, 'wb')
    for _ in range(4):
        json.loads(wf.readline())

    rows = []
    try:
        for row_i, n_clients in enumerate(cli.tcp_clients):
            wall, lats, srv_s = run_clients(
                n_clients, cli.tcp_req // n_clients,
                row_base=16 + 16 * row_i)
            n_done = n_clients * (cli.tcp_req // n_clients)
            rows.append({
                'clients': n_clients, 'n_requests': n_done,
                'req_per_s': round(n_done / wall, 3),
                'mean_latency_s': round(sum(lats) / len(lats), 3),
                'p50_latency_s': round(_pct(lats, 50), 3),
                'p95_latency_s': round(_pct(lats, 95), 3),
                # the device's share of a request, measured by the server:
                # client latency beyond it is host scheduling and queueing
                'mean_server_render_s': round(sum(srv_s) / len(srv_s), 3),
            })
            print(rows[-1], flush=True)
    finally:
        ws.sendall(b'{"cmd": "quit"}\n')
        srv.join(timeout=60)
        ws.close()
    base = rows[0] if rows else None
    return {
        'req_per_row': cli.tcp_req,
        'rows': rows,
        'throughput_gain': (round(rows[-1]['req_per_s'] / base['req_per_s'],
                                  2) if base and len(rows) > 1 else None),
    }


if __name__ == '__main__':
    main()
