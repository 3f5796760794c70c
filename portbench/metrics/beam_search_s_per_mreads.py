"""beam_search_s_per_mreads: seconds in the beam search for the haplotypes of dense windows (the program's span beam_search, inside haplotypes: engine.caller._beam_search_haplotypes, one device round trip per candidate variant), per million reads of the window; 0 where the program counts beam windows (beam_windows) and none took the path; None where it has neither."""

from portbench.metrics._program import counters, span_per_mreads


def read(ctx):
    value = span_per_mreads(ctx, "beam_search")
    if value is None and "beam_windows" in counters() and ctx.reads:
        return 0.0
    return value
