"""Device busy time, kernel times and idle gaps from a torch.profiler
Chrome trace, over the benchmark's measured window.

Copied from chip_smoke.py trace_summary: the device is busy where a GPU
kernel, memcpy or memset runs (the union of their intervals).  The
window is the benchmark's own span WINDOW, not the first to the last
event, and idle gaps are labelled by the benchmark's host span that holds
their midpoint.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def _union(intervals, lo, hi):
    """Sorted, merged (start, end) intervals clipped to [lo, hi]."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, spans=()):
    """The numbers of a trace's complete events ('ph' X, 'ts' and 'dur' in
    microseconds): window_s (the WINDOW span), busy_s (device-busy seconds
    inside it), kernel_s ({kernel name: seconds inside the window}),
    device_ops (the ten device operations with the most time, [name,
    seconds]) and
    idle_gaps (the ten longest gaps of the device, each [the span of
    `spans` that holds its midpoint, or 'other', seconds])."""
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"the trace has no {WINDOW} span")
    lo = window[0]["ts"]
    hi = lo + window[0]["dur"]
    intervals = []
    kernel_s, op_s = {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= lo or a >= hi:
            continue
        intervals.append((a, b))
        d = (min(b, hi) - max(a, lo)) / 1e6
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + d
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + d
    merged = _union(intervals, lo, hi)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("name") in spans and e.get("cat") == "user_annotation")

    def label(a, b):
        mid = (a + b) / 2
        names = [n for s, t, n in host if s <= mid < t]
        return names[-1] if names else "other"

    gaps.sort(key=lambda g: g[0] - g[1])
    return dict(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in merged) / 1e6,
        kernel_s=kernel_s,
        device_ops=[[n, s] for n, s in sorted(op_s.items(),
                                               key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[label(a, b), (b - a) / 1e6] for a, b in gaps[:10]])


def load_events(path):
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]
