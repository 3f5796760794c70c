"""unspanned_s_per_mreads: seconds of the window in which the pipeline thread is in no span below a stage: the window less the self seconds of every span that thread opened except the stage spans and its outermost run span, per million reads of the window.  It measures how much of the window the program's spans account for."""

from portbench.metrics._program import ROOT, STAGES, pipeline_self_times


def read(ctx):
    self_times = pipeline_self_times()
    if not self_times or not ctx.reads:
        return None
    covered = sum(s for name, s in self_times.items()
                  if name not in STAGES and name != ROOT)
    return (ctx.window_s - covered) / (ctx.reads / 1e6)
