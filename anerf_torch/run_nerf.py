"""Training CLI (torch port of run_nerf.py, the equivalent of the
reference's run_nerf.py):

  python -m anerf_torch.run_nerf --config configs/surreal/surreal.txt \
      [--flag value ...] [--mesh_shape N]
  torchrun --nproc_per_node N -m anerf_torch.run_nerf --config ...

Trains on the GPU, data parallel over `--mesh_shape` GPUs (every visible
one when it is not given, as in the JAX package): one process a device,
spawned here (parallel/mesh.py:run_ranks) or started by torchrun, which
they then join. `main(argv, **train_kwargs)` passes its keywords to
train/loop.py:train (a dataset object, log_fn, device='cpu' for tests,
save_images=False where imageio is absent); `devices=` (one per rank; it
may name one card twice), `backend=` and `init=` go to run_ranks, and
`mesh=` runs this process as a rank of a mesh already made. With more
than one rank it returns rank 0's final state as the checkpoint's tree
(a TrainContext does not cross processes).
"""
from __future__ import annotations

import os
import sys


def main(argv=None, devices=None, backend=None, init=None, mesh=None,
         **train_kwargs):
    from anerf_torch.config import load_config
    from anerf_torch.parallel.mesh import (default_devices, make_mesh,
                                          ranks_wanted, run_ranks)
    from anerf_torch.train.loop import train

    args = load_config(argv if argv is not None else sys.argv[1:])
    device = train_kwargs.get('device', 'cuda')
    if mesh is None and 'WORLD_SIZE' in os.environ:
        mesh = make_mesh(args.mesh_shape, devices, backend, device)
    if mesh is not None:
        if mesh.rank == 0:
            print(f'experiment: {args.expname} -> {args.basedir} '
                  f'({mesh.size} ranks)')
        return train(args, mesh=mesh, **train_kwargs)
    n = ranks_wanted(args.mesh_shape, device, devices)
    if n > 1:
        devices = devices or default_devices(n, device)
        return run_ranks(_rank, n, devices, backend, init,
                         args=(args, train_kwargs))[0]
    print(f'experiment: {args.expname} -> {args.basedir}')
    return train(args, **train_kwargs)


def _rank(mesh, args, train_kwargs):
    """One spawned rank of main(); rank 0 returns the final state as the
    checkpoint's tree (train/checkpoint.py:state_tree, on the host)."""
    from anerf_torch.train.checkpoint import state_tree
    from anerf_torch.train.loop import train

    train_kwargs = {k: v for k, v in train_kwargs.items() if k != 'device'}
    ctx = train(args, mesh=mesh, **train_kwargs)
    return state_tree(ctx.state) if mesh.rank == 0 else None


if __name__ == '__main__':
    main()
