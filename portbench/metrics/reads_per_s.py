"""reads_per_s: the reads the traffic generator placed in every region the
window yielded (by leftmost position, every sample), over the window's
seconds, from the first yield to run_single_process's return."""


def read(ctx):
    return ctx.reads / ctx.window_s
