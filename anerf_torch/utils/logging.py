"""Metrics logging: JSONL always; TensorBoard when available (torch port of
anerf_tpu/utils/logging.py's MetricsLogger).

Mirrors the reference's SummaryWriter usage (run_nerf.py:528-616): per-loss
scalars, stats (psnr, alpha, grad norms, MPJPC), validation metrics. The
JSONL stream is the source of truth (grep/pandas-able); TB is an optional
view via torch.utils.tensorboard. The JAX package's DeviceProfiler
(jax.profiler) has no counterpart here yet (ROADMAP.md Queue 1 item 4).
"""
from __future__ import annotations

import json
import os
from typing import Dict


class MetricsLogger:

    def __init__(self, exp_dir: str, use_tensorboard: bool = True):
        self.jsonl = open(os.path.join(exp_dir, 'metrics.jsonl'), 'a')
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(os.path.join(exp_dir, 'tb'))

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = '') -> None:
        rec = {'step': step}
        for k, v in scalars.items():
            rec[f'{prefix}{k}'] = float(v)
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f'{prefix}{k}', float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
