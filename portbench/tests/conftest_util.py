"""Helpers of the portbench CPU tests: tiny cells built from the real
configuration and traffic files, run through the harness on the CPU."""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness.core import HERE, Cell, load_json  # noqa: E402


def tiny_cell(kind: str = "wgs", trace: bool = False) -> Cell:
    """A cell with the real files' settings at a size the CPU runs in
    seconds: wgs1's at 300 kb and 10x, or cohort16's with 4 samples over
    200 kb at 6x."""
    if kind == "wgs":
        cfg = load_json(HERE, "configs", "wgs1.json")
        cfg["genome_length"] = 300_000
        tr = load_json(HERE, "traffic", "wgs30x.json")
        tr["coverage"] = 10
    else:
        cfg = load_json(HERE, "configs", "cohort16.json")
        cfg.update(genome_length=200_000, samples=4)
        tr = load_json(HERE, "traffic", "cohort6x.json")
    bench = load_json(ROOT, "BENCHMARK.json")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if "workloads" not in m]
    limits = load_json(HERE, "limits", "wgs1_30x.json")
    # The tiny cohorts run at 6x with 4 samples: their calls are held only
    # to what sound runs of that size read, the kernels' numbers as they are.
    limits.update(missed_share=0.2, genotype_error_share=0.2,
                  extra_per_mb=50.0)
    return Cell("tiny", f"test_{kind}", cfg, "test", tr, limits, 1, metrics)


def run_tiny(kind="wgs", trace=False, seconds=2.0, seed=2**33 + 7,
             substitute=None):
    import torch

    from portbench.harness.core import run_cell

    return run_cell(tiny_cell(kind, trace), seed, seconds, trace,
                    time.perf_counter(), device=torch.device("cpu"),
                    substitute=substitute, overrides={"device_inference": 1})
