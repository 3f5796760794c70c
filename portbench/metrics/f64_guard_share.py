"""f64_guard_share: the share, in percent, of the windows K3 inferred on the device whose results the f64 guard of engine.caller.finish_window discarded and redid on the host in float64, from the program's counters device_windows_to_host over k3_windows."""

from portbench.metrics._program import counters


def read(ctx):
    c = counters()
    windows = c.get("k3_windows")
    if not windows:
        return None
    return 100.0 * c.get("device_windows_to_host", 0) / windows
