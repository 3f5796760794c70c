"""beam_window_share: the share, in percent, of the window's calling windows (each holds variants without --outputRefCalls) whose haplotypes came from the beam search rather than every subset of their variants, from the program's counters beam_windows over windows; None where the program has no beam_windows counter."""

from portbench.metrics._program import counters


def read(ctx):
    c = counters()
    if "beam_windows" not in c or not c.get("windows"):
        return None
    return 100.0 * c["beam_windows"] / c["windows"]
