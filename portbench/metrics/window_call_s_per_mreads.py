"""window_call_s_per_mreads: seconds in engine.caller.finish_window: the f64 guard, the host EM of guarded windows, posteriors and genotype calls, from the program's span window_call (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "window_call")
