"""finish_s_per_mreads: seconds in the finish (the f64 guard, INFO, VCF writing), from the engine timers window_finish + vcf_output, per million reads of the window."""

from portbench.metrics._timers import per_mreads


def read(ctx):
    return per_mreads(ctx, ('window_finish', 'vcf_output'))
