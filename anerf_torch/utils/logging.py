"""Metrics logging: JSONL always; TensorBoard when available (torch port of
anerf_tpu/utils/logging.py's MetricsLogger).

Mirrors the reference's SummaryWriter usage (run_nerf.py:528-616): per-loss
scalars, stats (psnr, alpha, grad norms, MPJPC), validation metrics. The
JSONL stream is the source of truth (grep/pandas-able); TB is an optional
view via torch.utils.tensorboard. DeviceProfiler captures a
torch.profiler trace of a window of steps into <exp>/profile, as the JAX
package's captures a jax.profiler trace.
"""
from __future__ import annotations

import json
import os
from typing import Dict

from . import trace


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


class DeviceProfiler:
    """torch.profiler trace capture around a window of steps (the JAX
    package's DeviceProfiler, on jax.profiler): `maybe_start(step)` starts
    it at `start_step`, `maybe_stop(step)` stops it once `step` reaches
    start_step + num_steps and writes a Chrome trace to
    <exp_dir>/profile/trace_<start>_<stop>.json. On a GPU it records the
    device's activity alone (which leaves the host's time nearly
    untouched), on the CPU the host's operators. `last` keeps the
    finished profile for key_averages() / events(). The port's host spans
    (utils/trace.py) are on while it records: their summary by name
    (`trace.summary`: count, total and self ms, work count) is written to
    spans_<start>_<stop>.json beside the trace (`spans_path`)."""

    def __init__(self, exp_dir: str, start_step: int = -1,
                 num_steps: int = 5):
        self.dir = os.path.join(exp_dir, 'profile')
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self.last = None
        self.trace_path = self.spans_path = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, step: int):
        if step == self.start_step and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            act = (ProfilerActivity.CUDA if torch.cuda.is_available()
                   else ProfilerActivity.CPU)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = profile(activities=[act])
            trace.take()
            trace.enable()
            self._prof.start()

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.stop_step:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            trace.disable()
            tag = f'{self.start_step}_{step}'
            self.trace_path = os.path.join(self.dir, f'trace_{tag}.json')
            self._prof.export_chrome_trace(self.trace_path)
            self.spans_path = os.path.join(self.dir, f'spans_{tag}.json')
            with open(self.spans_path, 'w') as f:
                json.dump(trace.summary(trace.take()), f, indent=1)
            self.last, self._prof = self._prof, None
