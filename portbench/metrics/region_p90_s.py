"""region_p90_s: the 90th percentile, over every region the window
yielded, of the seconds from its yield to its on_region_done."""

import statistics


def read(ctx):
    if len(ctx.region_s) < 10:
        return None
    return statistics.quantiles(ctx.region_s, n=10)[-1]
