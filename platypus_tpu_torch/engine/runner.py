"""Top-level entry of the torch port: one process, or a pool of them.

Twin of platypus_tpu/engine/runner.py: run_single_process with its
--HLATyping branch, run_variant_caller with the --distributed branch
(parallel/distributed.py) and the n_cpu > 1 pool, and continue_calling.
Region generation, BAM opening, logging setup, the VCF writer, the shared
region claim state (RegionClaimSource, with its settle gate, bow-out and
rescue) and the k-way merge are the JAX package's host code, used
read-only.  --meshDevices needs no code here: the region stages read it
from the config (engine/region.py), in the single process and in a pool's
device worker alike.  --usePallas is accepted and ignored: on CUDA the
hand-written kernels are the path.

The pool (n_cpu > 1) is the JAX package's hybrid pool:

* n_cpu host workers are the pool's host half, not a fallback: each runs
  the JAX package's own worker entry (platypus_tpu.engine.runner
  ._worker_entry), pinned to the CPU (PLATYPUS_TPU_PLATFORM=cpu,
  JAX_PLATFORMS=cpu, PLATYPUS_TPU_DEVICE_FLANK=0): native alignment and
  float64 host inference, which import neither jax nor torch.  The JAX
  package's host workers never touch a device either.
* at most one device worker (_n_device_workers) runs this module's
  run_single_process on the run's torch.device, claiming whole regions
  from the same shared index.
* with no device worker, --inferenceService=1 starts the device-owner
  service (engine/device_service.py), which serves the host workers'
  fused inference on the run's device.

Every process of the pool is spawned: importing torch starts threads, so
the parent is never forked.  A spawned child re-imports the parent's
__main__, which is why cli.py imports this module only inside main().
Unlike the JAX package, a device worker that exits non-zero without
being terminated by the parent fails the run, and so does a service that
failed to start or recorded an error: the device is never silently
replaced by the host path.
"""

from __future__ import annotations

import glob
import json
import logging
import multiprocessing
import os
import signal
import sys
import time
from typing import Dict, List, Optional

import torch

from platypus_tpu.config import PlatypusConfig, derive_runtime
from platypus_tpu.engine import runner as host_runner
from platypus_tpu.engine.region import RegionPrefetch
from platypus_tpu.engine.runner import (Region, RegionClaimSource,
                                        _cap_worker_threads, _chrom_sort_key,
                                        _config_from_reference_header,
                                        _crash_after_first_claim,
                                        _delayed_regions, get_regions,
                                        merge_vcf_files, open_bams,
                                        setup_logging)
from platypus_tpu.io.fasta import FastaFile
from platypus_tpu.vcfout.writer import VCFWriter

from ..ops import align_cuda
from ..parallel import batch
from ..parallel.distributed import run_distributed
from ..utils.backend import DeviceError
from .device_service import DeviceService, should_start_service
from .hla import call_hla_variants_in_region
from .region import (begin_region_inference, finish_region_call,
                     prepare_region_call)

logger = logging.getLogger("platypus_tpu")

# The environment of a host worker: the JAX package's CPU pin, and its
# flank path kept off the Pallas dispatch (which would import jax).
HOST_WORKER_ENV = {"PLATYPUS_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
                   "PLATYPUS_TPU_DEVICE_FLANK": "0"}

# What the device worker reports back through its shared counter array:
# regions it finished (written or skipped), launches per kernel library and
# fused-inference batches, all counted in the worker's own process.
DEVICE_COUNTS = ("regions", *align_cuda.KERNELS, "batches")

# Seconds the parent grants a terminated device worker before killing it.
_TERM_GRACE_S = 15.0


def run_single_process(
    config: PlatypusConfig,
    regions,
    output_path: str,
    device: torch.device,
    append: bool = False,
    on_region_done=None,
) -> int:
    """Call the given regions (a sequence, or a lazy source such as a
    RegionClaimSource iterator) into one VCF file on `device` (with
    --HLATyping=1, through run_hla_regions).

    Three-deep region pipeline (runner.py:176-186): while region k does
    its host work and queues its alignments, region k-1's scores are
    awaited and its inference queued, and region k-2's inference is
    gathered and written.  Output stays in region order because writes
    happen only in finish_region_call.  A region whose host stages raise
    is logged and skipped, as in the JAX package; a DeviceError stops the
    run.  `on_region_done(region)` is called once per region, after its
    lines are flushed or once it was skipped (runner.py:227-237)."""
    bam_files, samples_by_bam, samples = open_bams(config)
    ref_file = FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
    rt = derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen

    out = sys.stdout if output_path == "-" else open(
        output_path, "a" if append else "w")
    writer = VCFWriter(out, samples, options_line=config.to_json())
    if not append:
        writer.write_header()

    def done(region) -> None:
        if on_region_done is not None:
            out.flush()  # the region's lines are durable first
            on_region_done(tuple(region))

    def begin(state) -> bool:
        try:
            begin_region_inference(state, config, device)
            return True
        except DeviceError:
            raise
        except Exception:  # noqa: BLE001 — region crash containment
            logger.exception("Region %s:%s-%s will be skipped",
                             state.chrom, state.start, state.end)
            done((state.chrom, state.start, state.end))
            return False

    def finish(state) -> int:
        try:
            n = finish_region_call(state, ref_file, config, writer, device)
        except DeviceError:
            raise
        except Exception:  # noqa: BLE001 — region crash containment
            n = 0
            logger.exception("Region %s:%s-%s will be skipped",
                             state.chrom, state.start, state.end)
        done((state.chrom, state.start, state.end))
        return n

    region_iter = iter(regions)
    n_written = 0
    aligning = None   # PreparedRegion whose alignments are in flight
    inferring = None  # PreparedRegion whose inference is in flight
    prefetch = None   # next region's BAM decode on a helper thread
    try:
        if config.hla_typing:
            return run_hla_regions(config, region_iter, bam_files,
                                   samples_by_bam, ref_file, rt, out, device,
                                   done)
        # One-region lookahead, so the BAM prefetch has a target: a worker
        # claims at most one region ahead of the one it is preparing.
        cur = next(region_iter, None)
        index = 0
        while cur is not None:
            chrom, start, end = cur
            if index % 10 == 0:
                logger.info("Processing region %s:%s-%s", chrom, start, end)
            try:
                state = prepare_region_call(chrom, start, end, bam_files,
                                            samples_by_bam, ref_file, config,
                                            rt, device, preloaded=prefetch)
            except DeviceError:
                raise
            except Exception:  # noqa: BLE001 — region crash containment
                logger.exception("Region %s:%s-%s will be skipped",
                                 chrom, start, end)
                state = None
            if state is None:
                done(cur)  # skipped: no output will come
            if prefetch is not None:
                prefetch.join()  # never leave the helper running into a fetch
                prefetch = None
            nxt = next(region_iter, None)
            if nxt is not None:
                prefetch = RegionPrefetch(bam_files, samples_by_bam, *nxt,
                                          config)
            if aligning is not None and not begin(aligning):
                aligning = None
            if inferring is not None:
                n_written += finish(inferring)
            inferring, aligning = aligning, state
            cur = nxt
            index += 1
        if inferring is not None:
            n_written += finish(inferring)
        if aligning is not None and begin(aligning):
            n_written += finish(aligning)
    finally:
        if prefetch is not None:
            prefetch.join()
        if output_path != "-":
            out.close()
        for bam in bam_files:
            bam.close()
        ref_file.close()
    return n_written


def run_hla_regions(config: PlatypusConfig, regions, bam_files,
                    samples_by_bam, ref_file, rt, out, device: torch.device,
                    done) -> int:
    """--HLATyping=1: every region in order through the port's
    call_hla_variants_in_region, writing to `out` (runner.py:275-298).
    A region that fails on the host is skipped and logged as there; a
    DeviceError stops the run.  `done(region)` follows each region."""
    n_written = 0
    for index, (chrom, start, end) in enumerate(regions):
        if index % 10 == 0:
            logger.info("Processing region %s:%s-%s", chrom, start, end)
        try:
            n_written += call_hla_variants_in_region(
                chrom, start, end, bam_files, samples_by_bam, ref_file,
                config, rt, out, device)
        except DeviceError:
            raise  # the region's device work is not contained
        except Exception:  # noqa: BLE001 — region crash containment
            logger.exception("Region %s:%s-%s will be skipped",
                             chrom, start, end)
        done((chrom, start, end))
    return n_written


def _n_device_workers(config: PlatypusConfig, n_host: int,
                      device: torch.device) -> int:
    """How many device workers join the n_host host workers: 0 or 1, as
    in the JAX package (runner.py:823-850).  --tpuWorkers and
    PLATYPUS_TPU_HYBRID_WORKER mean what they mean there: 0 off, 1 on.
    Auto (-1): one when the run's device is CUDA, --workerPlatform is
    left at auto, and the host workers leave a core free."""
    mode = config.tpu_workers
    env = os.environ.get("PLATYPUS_TPU_HYBRID_WORKER")
    if env is not None:
        mode = int(env)
    if mode == 0 or n_host < 1:
        return 0
    if mode == -1 and (device.type != "cuda"
                       or config.worker_platform not in ("auto", "default")
                       or n_host >= (os.cpu_count() or 1)):
        return 0
    return 1


def _device_worker_entry(config_json: str, source: RegionClaimSource,
                         path: str, device: torch.device, counts) -> None:
    """A spawned device worker: the port's run_single_process on `device`
    over the regions it claims from the shared index (twin of the device
    half of runner.py:562-677).  After each region it stores its counts
    (DEVICE_COUNTS) in the shared `counts` array, then marks the region
    durable."""
    # The parent may terminate this worker before it opens its output;
    # the merge must find the file all the same.
    open(path, "a").close()
    config = PlatypusConfig.from_json(config_json)
    # Its host stages share the cores with the host workers.
    _cap_worker_threads(config.n_cpu)
    torch.set_num_threads(int(os.environ["PLATYPUS_TPU_WORKER_THREADS"]))
    setup_logging(config, continuing=True)

    # The parent terminates a straggler once every region is durable:
    # SIGTERM becomes a SystemExit at a bytecode boundary, so a held claim
    # lock unwinds through its `with` block (runner.py:655-668).
    def graceful_term(_sig, _frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, graceful_term)
    # Own the device before claiming: a worker that cannot use it fails
    # now, not after taking regions.
    torch.empty(1, device=device)
    regions = iter(source)
    delay = float(os.environ.get("PLATYPUS_TPU_TEST_DEVICE_DELAY", "0") or 0)
    if delay:
        regions = _delayed_regions(regions, delay)
    if os.environ.get("PLATYPUS_TPU_TEST_DEVICE_CRASH"):
        regions = _crash_after_first_claim(regions)
    n_done = 0

    def on_done(region) -> None:
        nonlocal n_done
        n_done += 1
        values = dict(align_cuda.LAUNCHES, regions=n_done,
                      batches=batch.BATCHES)
        for k, name in enumerate(DEVICE_COUNTS):
            counts[k] = values[name]
        source.mark_done(region)

    run_single_process(config, regions, path, device, on_region_done=on_done)


def _start(proc, env: Dict[str, str]) -> None:
    """Start a spawned process with `env` laid over this one's environment
    (spawn snapshots os.environ at start)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _raise_if_failed(workers, terminated, temp_files) -> None:
    """RuntimeError if a worker exited non-zero and the parent did not
    terminate it: a host worker's claimed regions would be missing, and a
    device worker must not be replaced by the host path unseen."""
    failed = [i for i, p in enumerate(workers)
              if p.exitcode not in (None, 0) and i not in terminated]
    if failed:
        raise RuntimeError(
            f"worker process(es) {[workers[i].name for i in failed]} exited "
            f"with {[workers[i].exitcode for i in failed]}; the run fails "
            f"rather than merge without them. Temp files kept: "
            f"{[temp_files[i] for i in failed]}")


def run_pool(config: PlatypusConfig, regions: List[Region],
             device: torch.device) -> dict:
    """The n_cpu > 1 run (runner.py:885-1064): spawned host workers, at
    most one device worker or the inference service, the parent's watch
    loop, then the k-way merge into config.output.  Returns the pool's
    summary: claim counts, and the device worker's DEVICE_COUNTS."""
    n_host = min(config.n_cpu, max(1, len(regions)))
    n_device = _n_device_workers(config, n_host, device)
    n_workers = n_host + n_device
    temp_files = [f"{config.output}_temp_{i}" for i in range(n_workers)]
    ctx = multiprocessing.get_context("spawn")
    service = (DeviceService(ctx, n_workers, device)
               if n_device == 0 and should_start_service(config, n_workers,
                                                         device)
               else None)
    for stale in glob.glob(f"{config.output}_rescue_*"):
        os.remove(stale)  # a crashed earlier run must not leak into the merge
    for name in temp_files:
        open(name, "w").close()

    claim_index = ctx.Value("i", 0)
    claim_state = ctx.Array("b", len(regions))
    claim_completed = ctx.Array("b", len(regions))
    counts = ctx.Array("q", len(DEVICE_COUNTS))
    parent_source = RegionClaimSource(regions, claim_index, claim_state,
                                      claim_completed, n_host)

    def source(is_device: bool) -> RegionClaimSource:
        return RegionClaimSource(regions, claim_index, claim_state,
                                 claim_completed, n_host, is_device=is_device)

    # A host worker's --deviceInference=1 means "on the device", which for
    # it is the service: the JAX package's in-worker device path needs jax.
    host_config = PlatypusConfig.from_json(config.to_json())
    if host_config.device_inference == 1:
        host_config.device_inference = -1
    workers = [ctx.Process(target=host_runner._worker_entry,
                           args=((host_config.to_json(), source(False),
                                  temp_files[i],
                                  service.handle_for(i) if service else None,
                                  None),),
                           name=f"ptpu-host-{i}")
               for i in range(n_host)]
    workers += [ctx.Process(target=_device_worker_entry,
                            args=(config.to_json(), source(True),
                                  temp_files[i], device, counts),
                            name="ptpu-device-worker")
                for i in range(n_host, n_workers)]
    terminated: Dict[int, float] = {}  # device worker -> kill deadline
    try:
        for i, proc in enumerate(workers):
            _start(proc, HOST_WORKER_ENV if i < n_host else {})
            if i >= n_host:
                # Yield the device worker's start (interpreter, torch,
                # context) to the host workers (runner.py:941-952).
                try:
                    os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
                except OSError:
                    pass
        while any(p.is_alive() for p in workers):
            for p in workers:
                p.join(timeout=0.5)
            if service is not None:
                service.check_alive()
            _raise_if_failed(workers, terminated, temp_files)
            for i, deadline in list(terminated.items()):
                if workers[i].is_alive() and time.monotonic() > deadline:
                    logger.warning("Device worker ignored SIGTERM; killing")
                    workers[i].kill()
            if n_device and parent_source.all_done():
                # Every region is durable (rescues included): a straggler
                # must not extend the run; its duplicate lines are dropped
                # at merge time.
                for i in range(n_host, n_workers):
                    if workers[i].is_alive() and i not in terminated:
                        logger.info("Terminating the device worker (all "
                                    "regions complete)")
                        workers[i].terminate()
                        terminated[i] = time.monotonic() + _TERM_GRACE_S
        _raise_if_failed(workers, terminated, temp_files)
    except BaseException:
        for p in workers:
            if p.is_alive():
                p.kill()
        for p in workers:
            p.join(timeout=10)
        if service is not None:
            service.stop()
        raise
    if service is not None:
        service.stop()
        service.raise_if_failed()
    n_h, n_d, n_r = parent_source.claim_counts()
    summary = dict(host=n_h, device=n_d, rescued=n_r, terminated=len(terminated),
                   **dict(zip(DEVICE_COUNTS, counts[:])))
    logger.info("pool: %s", json.dumps(summary))
    merge_vcf_files(temp_files + sorted(glob.glob(f"{config.output}_rescue_*")),
                    config.output)
    return summary


def run_variant_caller(config: PlatypusConfig, device: torch.device,
                       regions: Optional[List[Region]] = None,
                       continuing: bool = False) -> Optional[dict]:
    """`callVariants` on `device`: with --distributed, this process's
    share of a multi-host run (parallel/distributed.run_distributed);
    else one process for n_cpu <= 1 (appending when `continuing`), or
    run_pool, whose summary it returns."""
    setup_logging(config, continuing)
    if config.distributed:
        run_distributed(config, device)
        return None
    if regions is None:
        regions = get_regions(config)
    regions = sorted(regions, key=lambda r: (_chrom_sort_key(r[0]), r[1], r[2]))
    if config.n_cpu <= 1:
        run_single_process(config, regions, config.output, device,
                           append=continuing)
        return None
    return run_pool(config, regions, device)


def continue_calling(vcf_path: str, device: torch.device) -> None:
    """Resume an interrupted single-process run from its partial VCF
    (twin of runner.py:1097-1157): re-call from the region holding the last
    written record into `<vcf>_ContinuedFromFailedProcess.vcf`, which keeps
    the completed lines before it."""
    config = None
    last_chrom = None
    last_pos = 0
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("##platypusOptions="):
                body = line.split("=", 1)[1].strip()
                try:
                    config = PlatypusConfig.from_json(body)
                except Exception:  # noqa: BLE001 — reference-format header
                    config = _config_from_reference_header(body)
            elif not line.startswith("#"):
                cols = line.split("\t", 2)
                last_chrom = cols[0]
                last_pos = int(cols[1])
    if config is None:
        raise ValueError(f"{vcf_path} has no platypusOptions header; cannot resume")
    if config.n_cpu > 1:
        raise ValueError("Resume is only supported for single-process runs")

    # A region is the unit of progress: resume from the start of the one
    # holding the last written record (runner.py:242-262).
    remaining = []
    resume_floor = 0
    seen_last = last_chrom is None
    for chrom, start, end in get_regions(config):
        if last_chrom is None:
            remaining.append((chrom, start, end))
        elif chrom == last_chrom and start <= last_pos - 1 < end:
            seen_last = True
            resume_floor = start
            remaining.append((chrom, start, end))
        elif seen_last:
            remaining.append((chrom, start, end))

    stem = vcf_path[:-4] if vcf_path.endswith(".vcf") else vcf_path
    new_path = stem + "_ContinuedFromFailedProcess.vcf"
    with open(vcf_path) as src, open(new_path, "w") as dst:
        for line in src:
            if line.startswith("#"):
                dst.write(line)
            else:
                cols = line.split("\t", 2)
                if cols[0] != last_chrom or int(cols[1]) - 1 < resume_floor:
                    dst.write(line)
    config.output = new_path
    run_variant_caller(config, device, regions=remaining, continuing=True)
