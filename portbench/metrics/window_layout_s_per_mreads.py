"""window_layout_s_per_mreads: seconds in the region's window layout: candidates.windows.generate_windows, engine.score.RegionReadMatrix.build, the per-buffer window slices and the --compressReads block, from the program's span window_layout (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "window_layout")
