"""Timing and throughput counters.

The reference has no tracer — only verbosity-gated debug dumps and malloc
wrappers for profilers (SURVEY.md §5).  Here `Metrics` keeps cheap
hierarchical wall-clock timers + counters, logged per region (reads/s,
windows/s, device call counts).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger("platypus_tpu")


class Metrics:
    def __init__(self) -> None:
        self.timers: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] += time.perf_counter() - t0

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def rate(self, counter: str, timer: str) -> Optional[float]:
        t = self.timers.get(timer, 0.0)
        if t <= 0:
            return None
        return self.counters.get(counter, 0) / t

    def summary(self) -> str:
        parts = []
        for name in sorted(self.timers):
            parts.append(f"{name}={self.timers[name]:.2f}s")
        for name in sorted(self.counters):
            parts.append(f"{name}={self.counters[name]}")
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
        self.timers.clear()
        self.counters.clear()


# Process-global metrics instance used by the engine.
GLOBAL_METRICS = Metrics()

