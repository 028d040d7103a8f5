"""Profiling hooks, counterpart of ``dmf_tpu/utils/profiling.py``.

The reference has only wall-clock prints (model_test.py:103).  The JAX
package wraps ``jax.profiler``; here :func:`trace` wraps ``torch.profiler``
(CPU and CUDA activities) and writes a Chrome trace, :func:`annotate` names
a span of it, and :class:`StepTimer` is the JAX package's rolling step
timer, unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where a card is present) and write a
    Chrome trace ``trace_<pid>.json`` into ``log_dir`` (viewable in Perfetto
    or ``chrome://tracing``); a no-op without ``log_dir``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Lightweight rolling step timer for the train loop: host seconds per
    ``with`` block, the first ``warmup`` blocks left out."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return False

    @property
    def mean_step_time(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        t = self.mean_step_time
        return 1.0 / t if t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "mean_step_time_s": self.mean_step_time,
            "steps_per_sec": self.steps_per_sec,
        }


def annotate(name: str):
    """Named span in a profiler timeline (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
