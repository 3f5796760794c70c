"""device_idle_share: the share of the measured window, in percent, in
which no kernel, memcpy or memset ran on the card (averaged over the
cards of the run)."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
