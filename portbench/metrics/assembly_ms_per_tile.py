"""assembly_ms_per_tile: milliseconds of the program's span assembly per tile it assembled (the counter assembly_tiles); None where the program has neither."""

from portbench.metrics._program import counters


def read(ctx):
    tiles = counters().get("assembly_tiles")
    if not tiles or "assembly" not in ctx.timers:
        return None
    return 1000.0 * ctx.timers["assembly"] / tiles
