"""Command-line interface of the torch port: `callVariants` only.

    python -m platypus_tpu_torch.cli callVariants --bamFiles=... --refFile=... -o out.vcf
    platypus-tpu-torch callVariants ...

Flags and their parsing are the JAX package's (platypus_tpu.cli.build_config).
Without an explicit device the run needs a CUDA card and fails without
one.  --calculateFlankScore=1 aligns its windows with the traceback
kernel, and --HLATyping=1 types each region as an HLA region.  --nCPU>1,
--meshDevices, --distributed and --inferenceService=1 raise
NotImplementedError; --usePallas is accepted and ignored (on CUDA the
hand-written kernels are the path).
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional

from platypus_tpu.cli import build_config

from .engine.runner import run_variant_caller
from .utils.backend import resolve_device

USAGE = "usage: platypus-tpu-torch callVariants [options]"


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
    if command != "callVariants":
        print(f"platypus-tpu-torch supports only callVariants, not "
              f"{command!r}; use platypus-tpu for it")
        return 2
    config = build_config(rest)
    run_variant_caller(config, resolve_device(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
