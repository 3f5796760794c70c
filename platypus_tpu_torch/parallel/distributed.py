"""Multi-host execution of the torch port: region sharding over
torch.distributed.

Every process of the run calls `initialize()`, takes its round-robin share
of the regions (shard_regions), calls it into its own temp VCF on its own
device, and after a barrier process 0 merges the shares with
engine/runner.merge_vcf_files.  No device tensor crosses
processes: the only collectives carry host counters and the barrier, so
the process group is gloo on the GPU too (NCCL would also refuse two
ranks on one card).  Rank r runs on cuda:{LOCAL_RANK % device_count}
unless the caller names its device.

Run one process per host (or per card):

    python -m platypus_tpu_torch.parallel.distributed callVariants ... \\
        --coordinatorAddress=host0:29500 --numProcesses=2 --processId=0

or under torchrun, whose MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
LOCAL_RANK environment `initialize()` reads, as
`python -m platypus_tpu_torch.cli callVariants ... --distributed=1`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import PlatypusConfig
from ..engine.runner import Region, get_regions, merge_vcf_files
from ..utils.backend import require_cuda
from ..utils.observability import GLOBAL_METRICS

logger = logging.getLogger("platypus_tpu")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the run's gloo process group; returns (rank, world size).
    With num_processes > 1 the group meets at tcp://coordinator_address;
    without arguments torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) names it.  A world of one needs no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a run of several processes needs the "
                             "coordinator address and this process's id")
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_regions(regions: List[Region], process_index: int,
                  process_count: int) -> List[Region]:
    """Deterministic round-robin region assignment (the reference's
    runner.py:470-474 scheme, by host instead of by fork)."""
    return [r for i, r in enumerate(regions) if i % process_count == process_index]


def shutdown() -> None:
    """Leave the run's process group.  A process that exits with the group
    still up can abort in gloo's teardown ("terminate called without an
    active exception") after its work is done."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device=None) -> torch.device:
    """The device this process calls on: `device` as given, unless it is
    a CUDA device without an index (or None), which becomes
    cuda:{LOCAL_RANK % device_count}."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    require_cuda()
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def barrier() -> None:
    """Every process waits for every other (twin of sync_global_devices);
    a no-op in a world of one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def aggregate_metrics(local: dict) -> dict:
    """Sum numeric metrics over every process of the run, over the sorted
    union of their keys (a key a process lacks counts 0 there); the
    identity in a world of one."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return dict(local)
    key_lists = [None] * dist.get_world_size()
    dist.all_gather_object(key_lists, sorted(local))
    keys = sorted({k for ks in key_lists for k in ks})
    if not keys:
        return {}
    vec = torch.tensor([float(local.get(k, 0)) for k in keys],
                       dtype=torch.float64)
    dist.all_reduce(vec)
    return {k: float(v) for k, v in zip(keys, vec.tolist())}


def run_distributed(config: PlatypusConfig, device=None,
                    coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None) -> None:
    """Whole run for one process of a multi-host run: its share of the
    regions into `<output>_host<rank>`, then process 0 merges the shares
    into config.output (one process writes config.output directly)."""
    from ..engine.runner import run_single_process

    pid, pcount = initialize(coordinator_address, num_processes, process_id)
    device = rank_device(device)
    regions = get_regions(config)
    mine = shard_regions(regions, pid, pcount)
    logger.info("host %d/%d: %d of %d regions on %s", pid, pcount, len(mine),
                len(regions), device)

    temp = f"{config.output}_host{pid}" if pcount > 1 else config.output
    run_single_process(config, mine, temp, device)

    totals = aggregate_metrics(dict(GLOBAL_METRICS.counters))
    if pid == 0 and totals:
        logger.info("slice totals: %s",
                    " ".join(f"{k}={int(v)}" for k, v in sorted(totals.items())))
    barrier()
    if pcount > 1 and pid == 0:
        merge_vcf_files([f"{config.output}_host{i}" for i in range(pcount)],
                        config.output)
    barrier()


def _main(argv=None, device=None) -> int:
    """`python -m platypus_tpu_torch.parallel.distributed` -- one process
    of a multi-host run: the callVariants flags plus --coordinatorAddress,
    --numProcesses and --processId (torchrun's environment without them).
    `device` None means this rank's CUDA device."""
    from ..cli import build_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    boot = argparse.ArgumentParser(add_help=False)
    boot.add_argument("--coordinatorAddress", default=None)
    boot.add_argument("--numProcesses", type=int, default=None)
    boot.add_argument("--processId", type=int, default=None)
    known, rest = boot.parse_known_args(argv)
    if rest and rest[0] == "callVariants":
        rest = rest[1:]
    config = build_config(rest)
    run_distributed(config, device, coordinator_address=known.coordinatorAddress,
                    num_processes=known.numProcesses,
                    process_id=known.processId)
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
