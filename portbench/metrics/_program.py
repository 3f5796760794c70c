"""What the span and counter readers share.

The harness's Context carries the window's span totals (ctx.timers) but
not the program's counters or its spans' self times: those readers take
them from the program's own utils/observability.GLOBAL_METRICS, which
holds the window's figures from its reset after the warm region until the
next run, and the readers run in between.  A span or counter the program
does not have reads None, as does a program whose Metrics keeps no self
times.
"""

from portbench.metrics._timers import per_mreads

# The stage spans of the region pipeline (engine/region.py) and the
# pipeline thread's outermost span (engine/runner.run_single_process):
# time in them but in no span below them is time no span accounts for.
STAGES = ("region_prepare", "region_begin", "region_finish")
ROOT = "run"


def span_per_mreads(ctx, name):
    """The span's total seconds per million reads of the window."""
    if name not in ctx.timers:
        return None
    return per_mreads(ctx, (name,))


def _metrics():
    from platypus_tpu_torch.utils import observability

    return observability.GLOBAL_METRICS


def counters():
    """The window's counters."""
    return dict(_metrics().counters)


def pipeline_self_times():
    """Self seconds of each span the pipeline thread opened, or None."""
    self_times = getattr(_metrics(), "self_times", None)
    return None if self_times is None else dict(self_times["pipeline"])
