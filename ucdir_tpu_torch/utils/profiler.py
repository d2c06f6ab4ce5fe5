"""Profiling hooks: `torch.profiler` traces and a step timer. Counterpart of
`ucdir_tpu/utils/profiler.py` (the reference has no profiling, only tqdm
bars). `trace` writes a Chrome trace that Perfetto or TensorBoard opens,
`annotate` names a region inside it, `StepTimer` keeps a moving average of
a step's wall time."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the enclosed code, the CPU and, where there is one, the
    card, and writes `<log_dir>/trace.json` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class StepTimer:
    """Exponential moving average of a step's wall time. Time what runs on
    the card only after a `torch.cuda.synchronize()` in the step."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            (1 - self.alpha) * self.avg + self.alpha * dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0


def annotate(name: str):
    """A named region inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
