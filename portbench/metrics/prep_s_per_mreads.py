"""prep_s_per_mreads: seconds in host preparation (BAM load, candidates, windows, haplotypes, pairs), from the engine timers region_load + candidate_generation + window_prepare, per million reads of the window."""

from portbench.metrics._timers import per_mreads


def read(ctx):
    return per_mreads(ctx, ('region_load', 'candidate_generation', 'window_prepare'))
