"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a host with the cards the cell asks
for.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, readings:
the numbers reported and not compared, and checks: each compared number
with its limit, which also end standard error).  Without CUDA, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded at
the end, it prints no result and exits non-zero.

--control bf16 runs the plain inference in bfloat16 in K3's place, and
--fault <name> plants a fault of harness/faults.py under the timed path:
they read the ends of `correct`'s limits, untraced, and the benchmark's
own runs never use them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    sys.path.insert(0, ROOT)
    from portbench.harness.faults import CONTROLS, FAULTS

    ap.add_argument("--control", choices=CONTROLS, default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)
    if args.control and args.fault:
        ap.error("--control and --fault are separate runs")
    if (args.control or args.fault) and args.trace:
        ap.error("--control and --fault run with --trace 0")
    import torch

    import platypus_tpu_torch  # noqa: F401  (the system under test)

    from portbench.harness.core import load_cell, run_cell
    from portbench.harness.guard import forbidden_modules

    cell = load_cell(ROOT, args.workload, bool(args.trace))
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                      substitute=args.control or args.fault)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, v in result["readings"].items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
