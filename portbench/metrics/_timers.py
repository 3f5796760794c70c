"""Seconds of engine timers (utils/observability.GLOBAL_METRICS) per
million of the window's reads."""


def per_mreads(ctx, names):
    if not ctx.reads:
        return None
    return sum(ctx.timers.get(n, 0.0) for n in names) / (ctx.reads / 1e6)
