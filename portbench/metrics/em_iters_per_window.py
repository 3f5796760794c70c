"""em_iters_per_window: the EM iterations K3 ran per window it inferred on the device, from the program's counters k3_em_iterations over k3_windows (real windows, not the pad)."""

from portbench.metrics._program import counters


def read(ctx):
    c = counters()
    windows, iterations = c.get("k3_windows"), c.get("k3_em_iterations")
    if not windows or iterations is None:
        return None
    return iterations / windows
