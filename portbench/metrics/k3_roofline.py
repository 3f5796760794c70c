"""k3_roofline: K3's share of its roofline over the window, in percent:
the summed least time of its launches (harness/roofline.py k3_bound_s:
the largest of bytes, transcendentals and f32 operations over their
rates, for the EM iterations each window ran) over the device time of
its kernels (infer_window_*) in the trace."""

PREFIX = "infer_window_"


def read(ctx):
    if ctx.trace is None or not ctx.k3_bound_s:
        return None
    busy = sum(s for n, s in ctx.trace["kernel_s"].items() if PREFIX in n)
    return 100.0 * ctx.k3_bound_s / busy if busy > 0 else None
