"""k1_roofline: K1's share of its roofline over the window, in percent:
the summed least time of its launches (harness/roofline.py k1_bound_s:
the larger of the integer operations over SMs x 64 x the max SM clock and
the bytes over 3.35 TB/s) over the device time of its kernel in the
trace."""

KERNEL = "band_align_pairs_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.k1_bound_s:
        return None
    busy = sum(s for n, s in ctx.trace["kernel_s"].items() if KERNEL in n)
    return 100.0 * ctx.k1_bound_s / busy if busy > 0 else None
