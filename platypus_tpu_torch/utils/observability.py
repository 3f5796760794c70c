"""Tracing, timing and throughput counters.

The reference has no tracer — only verbosity-gated debug dumps and malloc
wrappers for profilers (SURVEY.md §5).  Here:

* `Metrics`: cheap hierarchical wall-clock timers + counters, logged per
  region (reads/s, windows/s, device call counts).  Its updates hold a
  lock: with PLATYPUS_TPU_INFER_THREAD=1 the region pipeline's stages
  time themselves on two threads at once;
* `trace()`: context manager wrapping `torch.profiler.profile` for
  device-level traces viewable in Perfetto or TensorBoard (enabled with
  PLATYPUS_TPU_TRACE_DIR).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger("platypus_tpu")


class Metrics:
    def __init__(self) -> None:
        self.timers: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timers[name] += seconds

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def rate(self, counter: str, timer: str) -> Optional[float]:
        t = self.timers.get(timer, 0.0)
        if t <= 0:
            return None
        return self.counters.get(counter, 0) / t

    def summary(self) -> str:
        with self._lock:
            timers, counters = dict(self.timers), dict(self.counters)
        parts = []
        for name in sorted(timers):
            parts.append(f"{name}={timers[name]:.2f}s")
        for name in sorted(counters):
            parts.append(f"{name}={counters[name]}")
        reads_s = self.rate("reads", "region_total")
        if reads_s is not None:
            parts.append(f"reads/s={reads_s:.0f}")
        windows_s = self.rate("windows", "region_total")
        if windows_s is not None:
            parts.append(f"windows/s={windows_s:.1f}")
        return " ".join(parts)

    def log_summary(self, prefix: str = "") -> None:
        logger.info("%s%s", prefix, self.summary())

    def reset(self) -> None:
        with self._lock:
            self.timers.clear()
            self.counters.clear()


# Process-global metrics instance used by the engine.
GLOBAL_METRICS = Metrics()


@contextlib.contextmanager
def trace(label: str = "platypus") -> Iterator[None]:
    """Device-level profiler trace when PLATYPUS_TPU_TRACE_DIR is set: the
    body runs under torch.profiler (CPU, plus CUDA when a card is
    visible), which writes a Chrome trace (*.pt.trace.json) into
    $PLATYPUS_TPU_TRACE_DIR/<label>/ when the body ends.  Without the
    variable it does nothing and imports no torch."""
    trace_dir = os.environ.get("PLATYPUS_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
            os.path.join(trace_dir, label))):
        yield
