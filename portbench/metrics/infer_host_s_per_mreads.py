"""infer_host_s_per_mreads: seconds in the fused inference's host side (bucketing, uploads, launch, fetch), from the engine timers device_inference, per million reads of the window."""

from portbench.metrics._timers import per_mreads


def read(ctx):
    return per_mreads(ctx, ('device_inference',))
