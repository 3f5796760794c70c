"""align_host_s_per_mreads: seconds in the alignment's host side (uploads, index vectors, launches, wait, copy back, finalize), from the engine timers device_dispatch + device_alignment, per million reads of the window."""

from portbench.metrics._timers import per_mreads


def read(ctx):
    return per_mreads(ctx, ('device_dispatch', 'device_alignment'))
