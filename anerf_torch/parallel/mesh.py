"""Data parallelism over torch.distributed (torch port of
anerf_tpu/parallel/mesh.py).

The JAX package shards the ray axis of one global batch over a 1-D
`data` mesh (NamedSharding(P('data'))), replicates the params, and
jit's partitioner emits the gradient all-reduce (the reference scatters
ray chunks over local GPUs with nn.DataParallel,
core/raycasters.py:157). Here one process per device holds one mesh
position (a rank):

- the params are replicated: every rank starts from the same state and
  applies the same averaged gradients;
- every rank holds the whole global batch and takes its contiguous block
  of the ray axis (`shard_ray_batch`), the layout P('data') gives;
- what is reduced across rays but does not depend on the params (the
  near/far fill of rays that miss the cylinder, the BCE mask count) is
  taken over the whole batch on every rank, with no collective, so each
  ray's forward pass is the one-device pass; what depends on the params
  (the gradients, the logged losses) is averaged once: one
  `all_reduce_mean` a step, and on the fused branch one a network in
  fused_apply's backward for its weights and biases, which the step's
  then leaves out.

`run_ranks` spawns the ranks (the spawn start method: CUDA does not
survive a fork) and sets up their process group; under torchrun
(WORLD_SIZE in the environment) `make_mesh` joins the group torchrun
describes. Every process group and every join is bounded by a timeout,
so a rank that dies or hangs fails the run instead of stalling it
(a test or a check also bounds the whole run: run_ranks' deadline).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import socket
import time
import traceback
import uuid
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

DATA_AXIS = 'data'

#: JAX's shard_ray_batch's per-ray leaves
RAY_KEYS = ('rays', 'target_s', 'fgs', 'bgs', 'cam_idxs', 'pose_idx')

#: seconds a collective may wait for the other ranks
DEFAULT_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the 1-D data mesh: its rank, the mesh size,
    the process group its collectives run in (None: the default group)
    and the device it computes on."""
    rank: int
    size: int
    group: Any
    device: torch.device

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length n (a multiple
        of the mesh size)."""
        if n % self.size:
            raise ValueError(f'an axis of {n} does not split over '
                             f'{self.size} ranks')
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)


def default_backend(device) -> str:
    """nccl for CUDA devices, gloo for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def default_devices(n: int, device='cuda') -> list:
    """One device per rank: cuda:0 .. cuda:n-1, or the CPU n times."""
    if torch.device(device).type == 'cuda':
        return [torch.device('cuda', i) for i in range(n)]
    return [torch.device('cpu')] * n


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None,
              device='cuda') -> DataMesh:
    """This process's DataMesh over the default process group.

    The group is the one run_ranks set up, or, when none is set up yet,
    torchrun's (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT in the
    environment; `backend` defaults to nccl on CUDA and gloo on the CPU).
    `devices` holds one device per rank (as JAX's `devices=`, it may name
    one card twice: two ranks on one card, a correctness check only);
    without it the rank computes on cuda:LOCAL_RANK, which raises where
    no GPU is present, or on the CPU when `device` is 'cpu'. `n_devices`,
    JAX's mesh size, must be the world size. Raises when there is no
    group to join; nothing falls back to one device or to the CPU."""
    if not dist.is_initialized():
        if 'WORLD_SIZE' not in os.environ:
            raise RuntimeError('make_mesh: no process group; launch the '
                               'ranks with run_ranks or torchrun')
        dev = _rank_device(devices, int(os.environ['RANK']), device)
        dist.init_process_group(
            backend or default_backend(dev), init_method='env://',
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT))
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f'a mesh of {n_devices} devices in a process '
                         f'group of {size}')
    dev = _rank_device(devices, rank, device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    return DataMesh(rank=rank, size=size, group=None, device=dev)


def _rank_device(devices, rank: int, device) -> torch.device:
    if devices is not None:
        return resolve_device(devices[rank])
    if torch.device(device).type == 'cuda':
        return resolve_device(torch.device(
            'cuda', int(os.environ.get('LOCAL_RANK', 0))))
    return resolve_device(device)


def ranks_wanted(mesh_shape: Optional[int], device='cuda',
                 devices: Optional[Sequence] = None) -> int:
    """The mesh size an entry point asks for, by JAX's rule: `mesh_shape`
    devices, None meaning every visible one (the CUDA devices; the CPU
    is one device); an explicit `devices` list names one per rank."""
    if devices is not None:
        return len(devices)
    if mesh_shape is not None:
        return int(mesh_shape)
    if torch.device(device).type == 'cuda' and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def shard_ray_batch(mesh: DataMesh, batch: Dict[str, Any],
                    ray_keys=RAY_KEYS,
                    stacked: bool = False) -> Dict[str, Any]:
    """This rank's contiguous block of every per-ray leaf (`ray_keys`; on
    axis 1 when `stacked`: a leading scan-unroll axis); every other leaf
    (per-image pose tables, frame indices) and every None stays whole."""
    out = {}
    for k, v in batch.items():
        if v is None or k not in ray_keys:
            out[k] = v
        elif stacked:
            out[k] = v[:, mesh.block(v.shape[1])]
        else:
            out[k] = v[mesh.block(v.shape[0])]
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def all_reduce_mean(mesh: DataMesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a flat float buffer, in place: the sum
    (one all_reduce), then a division on every rank, so every rank holds
    the same bits."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return flat.div_(mesh.size)


def all_gather_rows(mesh: DataMesh, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's rows stacked in rank order along axis 0: each rank
    writes its rows into a zero-filled buffer of them all, and one
    all_reduce(SUM) fills in the others' (adding zeros is exact). The
    same code on NCCL and on gloo, CUDA tensors included."""
    n = rows.shape[0]
    full = rows.new_zeros((mesh.size * n,) + tuple(rows.shape[1:]))
    full[mesh.rank * n:(mesh.rank + 1) * n] = rows
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
    return full


def broadcast_batch(mesh: DataMesh, packed, layout=None):
    """Rank 0's packed batch (train/loop.py:pack_batch's byte buffer and
    layout; None on the other ranks) on every rank's device, in one
    broadcast of the bytes. The layout, whose first entry is the byte
    count, travels first with broadcast_object_list when `layout` is
    None; pass the returned one back on later calls (a run's batches
    keep their layout: rank 0 raises if it changes). Returns (device
    byte buffer, layout)."""
    if mesh.rank == 0:
        host, own = packed
        if layout is not None and own != layout:
            raise ValueError('the batch layout changed between dispatches')
    if layout is None:
        box = [own if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        layout = box[0]
    if mesh.rank == 0:
        on_gpu = mesh.device.type == 'cuda'
        buf = host.to(mesh.device, non_blocking=on_gpu and host.is_pinned())
    else:
        buf = torch.empty((layout[0],), dtype=torch.uint8,
                          device=mesh.device)
    dist.broadcast(buf, src=0, group=mesh.group)
    return buf, layout


def run_ranks(fn: Callable, n: int, devices: Optional[Sequence] = None,
              backend: Optional[str] = None, init: Optional[str] = None,
              args: tuple = (), timeout: float = DEFAULT_TIMEOUT,
              deadline: Optional[float] = None) -> list:
    """fn(mesh, *args) in n spawned processes, one a rank; returns their
    results in rank order (each pickled back: return host values).

    devices: one per rank (default: cuda:0 .. cuda:n-1; a CUDA device
    raises here, before any rank starts, where no GPU is present: the
    CPU only when the caller names it); backend: default_backend of rank 0's device
    (two ranks on one card need gloo: NCCL refuses them). init: a
    directory for a FileStore rendezvous; None: TCP on 127.0.0.1 at a
    free port. timeout bounds each collective; deadline, when given, the
    whole run (a training run or a server has none). A rank that raises
    or dies, or a run past its deadline, makes this raise, after every
    rank is stopped. fn must be importable by name (a module-level
    function): spawned processes start from a fresh import."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = default_devices(n)
    devices = [str(resolve_device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f'{len(devices)} devices for {n} ranks')
    backend = backend or default_backend(devices[0])
    if init is not None:
        method = 'file://' + os.path.join(os.path.abspath(init),
                                          f'store-{uuid.uuid4().hex}')
    else:
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            method = f'tcp://127.0.0.1:{s.getsockname()[1]}'
    ctx = mp.get_context('spawn')
    results_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, fn, args, devices, backend, method,
                               timeout, results_q))
             for r in range(n)]
    for p in procs:
        p.start()
    end = None if deadline is None else time.monotonic() + deadline
    results: Dict[int, Any] = {}
    lost = None      # when a rank was first seen gone without a result
    try:
        while len(results) < n:
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f'run_ranks: ranks '
                                   f'{sorted(set(range(n)) - set(results))}'
                                   f' did not finish in {deadline:.0f} s')
            try:
                rank, ok, value = results_q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                # a result can still be on its way through the queue
                lost = (lost or time.monotonic() + 5.0) if dead else None
                if dead and time.monotonic() > lost:
                    raise RuntimeError(_failures(results_q, procs, {}))
                continue
            if not ok:
                raise RuntimeError(_failures(results_q, procs,
                                             {rank: value}))
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def _failures(results_q, procs, failed, wait: float = 5.0) -> str:
    """Every rank's failure: one rank's error often breaks the others'
    collectives, so gather theirs (and the ranks that died) for a few
    seconds too, and report them all in rank order."""
    until = time.monotonic() + wait
    while time.monotonic() < until and any(p.is_alive() for p in procs):
        try:
            rank, ok, value = results_q.get(timeout=0.2)
        except queue.Empty:
            continue
        if not ok:
            failed[rank] = value
    for r, p in enumerate(procs):
        if r not in failed and p.exitcode not in (None, 0):
            failed[r] = f'exited with code {p.exitcode} and no result'
    return 'run_ranks: ' + ('\n'.join(
        f'rank {r} failed:\n{failed[r]}' for r in sorted(failed))
        or 'a rank exited without a result')


def _rank_main(rank, n, fn, args, devices, backend, method, timeout,
               results_q):
    """One spawned rank: join the group, run fn, report its result (or
    its traceback) to run_ranks."""
    try:
        dist.init_process_group(
            backend, init_method=method, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(devices=devices), *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results_q.put((rank, False, traceback.format_exc()))
        raise
    # by value: torch's queue would hand tensors over in shared memory,
    # which this process's exit takes away
    results_q.put((rank, True, pickle.dumps(result)))
