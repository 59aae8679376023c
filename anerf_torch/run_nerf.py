"""Training CLI (torch port of run_nerf.py, the equivalent of the
reference's run_nerf.py):

  python -m anerf_torch.run_nerf --config configs/surreal/surreal.txt \
      [--flag value ...]

Trains on the GPU; `main(argv, **train_kwargs)` passes its keywords to
train/loop.py:train (a dataset object, log_fn, device='cpu' for tests,
save_images=False where imageio is absent).
"""
from __future__ import annotations

import sys


def main(argv=None, **train_kwargs):
    from anerf_torch.config import load_config
    from anerf_torch.train.loop import train

    args = load_config(argv if argv is not None else sys.argv[1:])
    print(f'experiment: {args.expname} -> {args.basedir}')
    return train(args, **train_kwargs)


if __name__ == '__main__':
    main()
