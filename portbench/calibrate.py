"""Readings for the limits of `correct`: one cell, several seeds, each seed
run sound and with each control and fault of harness/faults.py, all in
one process (the dataset and the libraries are set up once).

    python3 portbench/calibrate.py --workload <name> --seeds <n>,<n>,... \
        --seconds <s> [--runs sound,bf16,candidates_half,...]

Every run is untraced and measures --seconds at the cell's own load.
Prints one JSON line a run: the seed, what stood in (None when sound),
`correct` under the cell's limits, reads_per_s, and every number the
comparison reads, compared or not.  The benchmark's runs never call this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from portbench.harness.faults import SUBSTITUTES

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", default=",".join(["sound", *SUBSTITUTES]))
    args = ap.parse_args(argv)
    runs = args.runs.split(",")
    unknown = [r for r in runs if r != "sound" and r not in SUBSTITUTES]
    if unknown:
        ap.error(f"unknown runs {unknown}")
    import torch

    from portbench.harness.core import load_cell, run_cell

    if not torch.cuda.is_available():
        print("portbench: calibration needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload, False)
    for seed in (int(s) for s in args.seeds.split(",")):
        for run in runs:
            sub = None if run == "sound" else run
            r = run_cell(cell, seed, args.seconds, False, time.perf_counter(),
                         substitute=sub)
            numbers = dict(r["readings"])
            numbers.update({k: c["value"] for k, c in r["checks"].items()})
            print(json.dumps(dict(
                seed=seed, run=run, correct=r["correct"],
                attempted=r["attempted"],
                reads_per_s=r["metrics"]["reads_per_s"]["value"],
                numbers=numbers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
