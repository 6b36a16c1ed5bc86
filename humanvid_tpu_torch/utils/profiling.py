"""Step timers and device traces.

The counterpart of ``humanvid_tpu/utils/profiling.py``: ``StepTimers``
keeps named wall-clock segments (the drivers use ``data`` and ``step``)
accumulated over steps and logs their per-step means with an ETA every
``log_every`` steps, as the reference's ``timers`` do. ``device_trace``
records a ``torch.profiler`` trace (host and, where there is a card, device
activity) and writes it as a Chrome trace under ``log_dir``; ``annotate``
names a region inside it (the training drivers name each ``train_step``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


class StepTimers:
    """Named wall-clock accumulators with periodic averaged logging + ETA."""

    def __init__(self, total_steps: int, log_every: int = 20,
                 log: Optional[logging.Logger] = None):
        self.total_steps = total_steps
        self.log_every = log_every
        self.logger = log or logger
        self.acc: Dict[str, float] = defaultdict(float)
        self.steps_done = 0
        self.t_start = time.time()

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.acc[name] += time.time() - t0

    def step(self, global_step: int, **scalars) -> None:
        """Call once per train step; logs averaged segments every N steps."""
        self.steps_done += 1
        if global_step % self.log_every:
            return
        done = self.steps_done
        segs = " ".join(f"{k} {v / done:.3f}s" for k, v in sorted(self.acc.items()))
        extra = " ".join(f"{k} {v:.4f}" for k, v in scalars.items())
        eta_h = ((time.time() - self.t_start) / done
                 * (self.total_steps - global_step) / 3600)
        self.logger.info("step %d/%d %s | %s | ETA %.2f h",
                         global_step, self.total_steps, extra, segs, eta_h)

    def averages(self) -> Dict[str, float]:
        d = max(self.steps_done, 1)
        return {k: v / d for k, v in self.acc.items()}


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Record a torch.profiler trace of the block into ``log_dir/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)


def annotate(name: str):
    """Named region inside a traced step (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
