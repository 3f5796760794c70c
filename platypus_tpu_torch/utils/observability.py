"""Tracing, timing and throughput counters.

The reference has no tracer — only verbosity-gated debug dumps and malloc
wrappers for profilers (SURVEY.md §5).  Here:

* `Metrics`: spans and counters, logged per region (reads/s, windows/s,
  kernel launches, K3's windows and EM iterations).  `timer(name)` opens
  a span: it keeps each name's total seconds in `timers` and its self
  seconds (the total less what its child spans on the same thread
  cover) in `self_times`, apart for the pipeline thread -- the thread
  whose outermost span is `run`, i.e. the one running
  engine/runner.run_single_process -- and for helper threads (the BAM
  prefetch and its local assembly).  A span inherits its
  parent's region (`chrom:start-end`).  While a torch.profiler session
  runs, each span also enters record_function("platypus.<name>@<region>"),
  so it lands in the same Chrome trace as the kernels, as a
  user_annotation; with no profiler active none is entered.  Updates hold
  a lock: the prefetch helper times its spans while the pipeline thread
  times its own;
* `trace()`: context manager wrapping `torch.profiler.profile` for
  device-level traces viewable in Perfetto or TensorBoard (enabled with
  PLATYPUS_TPU_TRACE_DIR), which also writes the spans' totals, self
  times and counters as metrics.json beside the trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger("platypus_tpu")

# The outermost span of the thread that runs the region pipeline.
RUN = "run"
PROFILER_PREFIX = "platypus."
# The seconds the spans spend on themselves (Span), below a thread's
# outermost span.
SPAN_OVERHEAD = "span_overhead"

_profiler_enabled = None


def _profiling() -> bool:
    """Whether a torch.profiler session is active; False without torch
    imported (no session can run then)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        _profiler_enabled = getattr(getattr(torch, "autograd", None),
                                    "_profiler_enabled", None)
        if _profiler_enabled is None:
            return False
    return _profiler_enabled()


class Span:
    """One timed extent of a thread (Metrics.timer): name, region, start
    and end on perf_counter, the enclosing span of the same thread, and
    whether a helper thread opened it.

    A span's own cost -- its bookkeeping and, under a profiler, entering
    and leaving its annotation -- lies outside its [start, end], is taken
    off the seconds of every span that encloses it, and is counted as the
    span SPAN_OVERHEAD: children add up to their parents, and a traced
    run reports each layer's own seconds."""

    __slots__ = ("metrics", "name", "region", "start", "end", "parent",
                 "helper", "child_s", "nested_s", "overhead_s",
                 "children_overhead_s", "_annotation", "_stack")

    def __init__(self, metrics: "Metrics", name: str,
                 region: Optional[str] = None):
        # Until __enter__, start holds the time the span was made: its
        # own cost counts from there.
        self.start = time.perf_counter()
        self.metrics, self.name, self.region = metrics, name, region
        self.parent = None
        self.child_s = 0.0              # seconds of the child spans
        self.nested_s = 0.0             # overhead inside [start, end]
        self.children_overhead_s = 0.0  # its children's own overhead
        self._annotation = None

    def __enter__(self) -> "Span":
        t0 = self.start
        stacks = self.metrics._stacks
        tid = threading.get_ident()
        stack = stacks.get(tid)
        if stack:
            parent = self.parent = stack[-1]
            self.helper = parent.helper
            if self.region is None:
                self.region = parent.region
        else:
            stack = stacks[tid] = []
            self.helper = self.name != RUN
        stack.append(self)
        self._stack = stack
        if _profiling():
            from torch.profiler import record_function

            label = PROFILER_PREFIX + self.name
            if self.region is not None:
                label += "@" + self.region
            self._annotation = record_function(label)
            self._annotation.__enter__()
        self.start = time.perf_counter()
        self.overhead_s = self.start - t0  # this span's own overhead
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        m = self.metrics
        stack = self._stack
        stack.pop()
        if not stack:
            del m._stacks[threading.get_ident()]
        seconds = self.end - self.start - self.nested_s
        self_times = m.self_times["helper" if self.helper else "pipeline"]
        with m._lock:
            m.timers[self.name] += seconds
            self_times[self.name] += seconds - self.child_s
            if self.children_overhead_s:
                m.timers[SPAN_OVERHEAD] += self.children_overhead_s
                self_times[SPAN_OVERHEAD] += self.children_overhead_s
        parent = self.parent
        if parent is not None:
            parent.child_s += seconds
            overhead = self.overhead_s + time.perf_counter() - self.end
            parent.nested_s += self.nested_s + overhead
            parent.children_overhead_s += overhead


class Metrics:
    def __init__(self) -> None:
        self.timers: Dict[str, float] = defaultdict(float)
        self.self_times: Dict[str, Dict[str, float]] = {
            "pipeline": defaultdict(float), "helper": defaultdict(float)}
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._stacks: Dict[int, list] = {}  # thread id -> open spans

    def timer(self, name: str, region: Optional[str] = None) -> Span:
        """A span `name` (see Span), region inherited when None."""
        return Span(self, name, region)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def wall(self, name: str = RUN) -> float:
        """Seconds of the spans `name`: those closed, plus the time so far
        of those open as a thread's outermost span."""
        now = time.perf_counter()
        open_s = sum(now - stack[0].start
                     for stack in list(self._stacks.values())
                     if stack and stack[0].name == name)
        return self.timers.get(name, 0.0) + open_s

    def snapshot(self) -> dict:
        """Span totals, self times by thread kind and counters."""
        with self._lock:
            return dict(timers=dict(self.timers),
                        self_times={k: dict(v)
                                    for k, v in self.self_times.items()},
                        counters=dict(self.counters))

    def summary(self) -> str:
        with self._lock:
            timers, counters = dict(self.timers), dict(self.counters)
        parts = []
        for name in sorted(timers):
            parts.append(f"{name}={timers[name]:.2f}s")
        for name in sorted(counters):
            parts.append(f"{name}={counters[name]}")
        wall = self.wall()
        if wall > 0:
            parts.append(f"reads/s={counters.get('reads', 0) / wall:.0f}")
            parts.append(f"windows/s={counters.get('windows', 0) / wall:.1f}")
        return " ".join(parts)

    def log_summary(self, prefix: str = "") -> None:
        logger.info("%s%s", prefix, self.summary())

    def reset(self) -> None:
        with self._lock:
            self.timers.clear()
            for by_name in self.self_times.values():
                by_name.clear()
            self.counters.clear()


# Process-global metrics instance used by the engine.
GLOBAL_METRICS = Metrics()


@contextlib.contextmanager
def trace(label: str = "platypus") -> Iterator[None]:
    """Device-level profiler trace when PLATYPUS_TPU_TRACE_DIR is set: the
    body runs under torch.profiler (CPU, plus CUDA when a card is
    visible), which writes a Chrome trace (*.pt.trace.json) into
    $PLATYPUS_TPU_TRACE_DIR/<label>/ when the body ends, beside
    metrics.json (GLOBAL_METRICS.snapshot()).  Without the variable it
    does nothing and imports no torch; inside a profiler session already
    running (an enclosing trace, the caller's own) it does nothing: one
    process runs one session at a time."""
    trace_dir = os.environ.get("PLATYPUS_TPU_TRACE_DIR")
    if not trace_dir or _profiling():
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    out = os.path.join(trace_dir, label)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(out)):
            yield
    finally:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "metrics.json"), "w") as fh:
            json.dump(GLOBAL_METRICS.snapshot(), fh, indent=1, sort_keys=True)
