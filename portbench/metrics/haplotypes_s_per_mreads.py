"""haplotypes_s_per_mreads: seconds in the per-window haplotype loop of engine.caller.prepare_window (read gathering, haplotype enumeration and merging, pair construction), from the program's span haplotypes (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "haplotypes")
