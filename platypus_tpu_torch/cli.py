"""Command-line interface of the torch port: `callVariants`,
`continueCalling`, `somatic` and `denovo`.

    python -m platypus_tpu_torch.cli callVariants --bamFiles=... --refFile=... -o out.vcf
    python -m platypus_tpu_torch.cli continueCalling --vcfFile=partial.vcf
    platypus-tpu-torch callVariants ...

Flags and their parsing are the JAX package's (platypus_tpu.cli.build_config).
Without an explicit device the run needs a CUDA card and fails without
one.  --calculateFlankScore=1 aligns its windows with the traceback
kernel, and --HLATyping=1 types each region as an HLA region.  --nCPU>1
runs the pool of engine/runner.py (host workers, at most one device
worker, or with --inferenceService=1 the device-owner service);
--meshDevices=N runs each region's step over a mesh of N GPUs
(parallel/mesh.py), and --distributed=1 one process of a multi-host run
(parallel/distributed.py); --usePallas is accepted and ignored (on CUDA
the hand-written kernels are the path).  `somatic` and `denovo` filter a
VCF on the host: they are the JAX package's own commands, which touch no
device.

The engine (and torch) are imported inside main(): the pool spawns its
workers, a spawned child re-imports this module as its __main__, and the
host workers must not pay for torch.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from platypus_tpu.cli import build_config
from platypus_tpu.cli import main as host_cli

USAGE = ("usage: platypus-tpu-torch {callVariants,continueCalling,somatic,"
         "denovo} [options]")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run a CLI command.  `device` None means CUDA (RuntimeError without
    a card); tests pass device="cpu" to run the plain torch versions."""
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if not argv or argv[0] in ("--help", "-h", "help"):
        print(USAGE)
        return 0 if argv else 2
    command, rest = argv[0], argv[1:]
    if command in ("somatic", "denovo"):
        return host_cli(argv)
    if command not in ("callVariants", "continueCalling"):
        print(f"unknown command {command!r}; use callVariants, "
              f"continueCalling, somatic or denovo")
        return 2
    from .engine.runner import continue_calling, run_variant_caller
    from .utils.backend import resolve_device

    if command == "continueCalling":
        parser = argparse.ArgumentParser(prog="platypus-tpu-torch continueCalling")
        parser.add_argument("--vcfFile", required=True)
        continue_calling(parser.parse_args(rest).vcfFile, resolve_device(device))
        return 0
    config = build_config(rest)
    run_variant_caller(config, resolve_device(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
