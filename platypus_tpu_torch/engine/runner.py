"""Top-level driver: region generation, one process or a pool of them, the
VCF merge, resume.

Equivalent of the reference driver (runner.py):

* get_regions: regions flag (chr:start-end list, .txt, .bed), else BAM SQ
  header, else FASTA index; split into bufferSize shards
  (platypusutils.pyx:935-1085);
* run_single_process: the three-deep region pipeline of one process, with
  the --HLATyping branch; --meshDevices needs no code here, the region
  stages read it from the config (engine/region.py), in the single process
  and in a pool's device worker alike;
* run_variant_caller: the --distributed branch (parallel/distributed.py),
  one process for n_cpu <= 1, else the pool, whose workers write temp
  VCFs that a k-way heap merge joins (runner.py:391-504, 29-121, 301-352);
* continue_calling: resume from an interrupted run by parsing the
  platypusOptions header line of the partial VCF (runner.py:197-297).

--usePallas is accepted and ignored: on CUDA the hand-written kernels are
the path.

The pool (n_cpu > 1):

* n_cpu host workers (_worker_entry) are the pool's host half: the region
  pipeline with device None -- native alignment and float64 host
  inference -- which imports no torch;
* at most one device worker (_n_device_workers) runs run_single_process on
  the run's torch.device, claiming whole regions from the same shared
  index (RegionClaimSource, with its settle gate, bow-out and rescue);
* with no device worker, --inferenceService=1 starts the device-owner
  service (engine/device_service.py), which serves the host workers'
  fused inference on the run's device.

Every process of the pool is spawned: importing torch starts threads, so
the parent is never forked.  A spawned child re-imports the parent's
__main__, which is why cli.py imports this module only inside main(), and
this module imports torch only where the device needs it.  A device worker
that exits non-zero without being terminated by the parent fails the run,
and so does a service that failed to start or recorded an error: the
device is never silently replaced by the host path.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import heapq
import json
import logging
import multiprocessing
import os
import re
import signal
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import PlatypusConfig, derive_runtime
from ..io.bam import BamFile, open_alignment_file
from ..io.fasta import FastaFile
from ..utils.backend import DeviceError
from ..utils.fileio import expand_bam_file_names, open_transparent
from ..utils.observability import GLOBAL_METRICS as metrics, RUN, trace
from ..vcfout.writer import VCFWriter
from .device_service import (DeviceService, set_service_handle,
                             should_start_service)
from .hla import call_hla_variants_in_region
from .region import (RegionPrefetch, begin_region_inference,
                     finish_region_call, prepare_region_call)

logger = logging.getLogger("platypus_tpu")

Region = Tuple[str, int, int]

# Seconds the parent grants a terminated device worker before killing it.
_TERM_GRACE_S = 15.0


def get_regions(config: PlatypusConfig) -> List[Region]:
    ref = FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
    bam = open_alignment_file(config.bam_files[0], ref_file=config.ref_file)

    regions: List[Region] = []
    if config.regions is not None and os.path.exists(config.regions[0]):
        path = config.regions[0]
        if path.endswith((".txt", ".txt.gz")):
            with open_transparent(path) as fh:
                for line in fh:
                    chrom, span = line.strip().rsplit(":", 1)
                    s, e = span.split("-")
                    # 1-based inclusive region strings; clamp "chr:0-..."
                    # (technically out of contract) to the contig start
                    # instead of producing a negative fetch start.
                    regions.append((chrom, max(0, int(s) - 1), int(e)))
        elif path.endswith((".bed", ".bed.gz")):
            with open_transparent(path) as fh:
                for line in fh:
                    try:
                        cols = line.split("\t")
                        regions.append((cols[0], int(cols[1]), int(cols[2])))
                    except Exception:  # noqa: BLE001
                        continue
    elif config.regions is None:
        header = bam.header_dict()
        if header.get("SQ"):
            regions = [(d["SN"], 0, int(d["LN"])) for d in header["SQ"]]
        else:
            regions = [(name, 0, entry.length) for name, entry in ref.refs.items()]
    else:
        for region in config.regions:
            split = region.rsplit(":", 1)
            chrom = split[0]
            if len(split) == 2 and "-" in split[1]:
                s, e = split[1].split("-")
                regions.append((chrom, max(0, int(s) - 1), int(e)))
            else:
                if chrom in ref.refs:
                    regions.append((chrom, 0, ref.refs[chrom].length))

    # Optional skip list (chr or chr:start-end per line / comma-separated).
    # NB: the reference parses --skipRegionsFile but never applies it
    # (runner.py:386-387,522); here it actually skips.
    skip_spans: List[Region] = []
    if config.skip_regions_file and os.path.exists(config.skip_regions_file):
        with open_transparent(config.skip_regions_file) as fh:
            for token in fh.read().replace(",", "\n").split():
                if ":" in token:
                    c, span = token.rsplit(":", 1)
                    s, e = span.split("-")
                    skip_spans.append((c, int(s) - 1, int(e)))
                else:
                    skip_spans.append((token, 0, 1 << 60))

    def skipped(chrom: str, start: int, end: int) -> bool:
        return any(c == chrom and start < e and end > s for c, s, e in skip_spans)

    final: List[Region] = []
    for chrom, start, end in regions:
        if chrom not in ref.refs:
            logger.warning("Contig %s not in reference; skipping", chrom)
            continue
        if start > ref.refs[chrom].length:
            continue
        if end - start > config.buffer_size:
            for i in range(start, end, config.buffer_size):
                shard = (chrom, i, min(i + config.buffer_size, end))
                if not skipped(*shard):
                    final.append(shard)
        elif not skipped(chrom, start, end):
            final.append((chrom, start, end))
    bam.close()
    ref.close()
    return final


def open_bams(config: PlatypusConfig):
    config.bam_files = expand_bam_file_names(list(config.bam_files))
    bam_files = [open_alignment_file(path, ref_file=config.ref_file)
                 for path in config.bam_files]
    samples_by_bam: Dict[BamFile, List[str]] = {}
    samples: List[str] = []
    for bam in bam_files:
        ss = bam.sample_names()
        samples_by_bam[bam] = ss
        samples.extend(ss)
    return bam_files, samples_by_bam, sorted(set(samples))


def run_single_process(
    config: PlatypusConfig,
    regions,
    output_path: str,
    device,
    append: bool = False,
    on_region_done=None,
) -> int:
    """Call the given regions (a sequence, or a lazy source such as a
    RegionClaimSource iterator) into one VCF file on `device`, a torch
    device or None for the host path (with --HLATyping=1, through
    run_hla_regions).

    Three-deep region pipeline (runner.py:176-186): while region k does
    its host work and queues its alignments, region k-1's scores are
    awaited and its inference queued, and region k-2's inference is
    gathered and written.  Output stays in region order because writes
    happen only in finish_region_call.  A region whose host stages raise
    is logged and skipped; a DeviceError stops the run.
    `on_region_done(region)` is called once per region, after its lines
    are flushed or once it was skipped (runner.py:227-237).

    The next region's BAM decode runs on a helper thread
    (engine/region.RegionPrefetch), started once region k is prepared, so
    that it overlaps the stage.  With --assemble=1 the helper also runs
    that region's local assembly, and it starts before prepare(k), as soon
    as region k's reads and assembly are in hand: the pipeline thread
    waits for them in `region_load` and takes both from the helper
    (counted as `assembly_prefetched`).  The first region loads and
    assembles inline.  Either way the source is asked for at most one
    region ahead, and the helper is the only BAM user while it runs.

    Begin (k-1) and finish (k-2) run on this thread, in that order, once
    region k is prepared; the prefetch helper is the only other thread.

    The call is the `run` span, which marks this thread as the pipeline
    thread of utils/observability.Metrics."""
    with metrics.timer(RUN):
        return _run_regions(config, regions, output_path, device, append,
                            on_region_done)


def _run_regions(config: PlatypusConfig, regions, output_path: str, device,
                 append: bool, on_region_done) -> int:
    """run_single_process's body, inside its `run` span."""
    with metrics.timer("run_setup"):
        bam_files, samples_by_bam, samples = open_bams(config)
        ref_file = FastaFile(config.ref_file,
                             parse_ncbi=bool(config.parse_ncbi))
        rt = derive_runtime(config, n_individuals=len(samples))
        rt.rlen = config.rlen

        out = sys.stdout if output_path == "-" else open(
            output_path, "a" if append else "w")
        writer = VCFWriter(out, samples, options_line=config.to_json())
        if not append:
            writer.write_header()

    def done(region) -> None:
        if on_region_done is not None:
            with metrics.timer("vcf_flush"):
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

    def stage(aligning, inferring):
        """begin(k-1), then finish(k-2): (region k-1 if it began, else
        None; lines written)."""
        begun = aligning if aligning is not None and begin(aligning) else None
        return begun, finish(inferring) if inferring is not None else 0

    region_iter = iter(regions)
    n_written = 0
    aligning = None   # PreparedRegion whose alignments are in flight
    inferring = None  # the region before it, whose inference is in flight
    prefetch = None   # next region's BAM decode on a helper thread

    def start_prefetch(region):
        if region is None:
            return None
        # Starting the thread hands it the interpreter lock, which this
        # thread may wait for: timed as prefetch_start.
        with metrics.timer("prefetch_start"):
            return RegionPrefetch(bam_files, samples_by_bam, *region, config,
                                  ref_file)

    try:
        if config.hla_typing:
            return run_hla_regions(config, region_iter, bam_files,
                                   samples_by_bam, ref_file, rt, out, device,
                                   done)
        # One-region lookahead, so the BAM prefetch has a target: a worker
        # claims at most one region ahead of the one it is preparing.
        # With --assemble=1 the helper also assembles its region, more
        # than the stage alone can hide, so region k+1's helper starts as
        # soon as region k's reads are in hand, before prepare(k); the
        # first region loads and assembles inline.
        cur = next(region_iter, None)
        index = 0
        while cur is not None:
            chrom, start, end = cur
            if index % 10 == 0:
                logger.info("Processing region %s:%s-%s", chrom, start, end)
            loaded = prefetch  # cur's helper, if it has one
            early = loaded is not None and bool(config.assemble)
            if early:
                with metrics.timer("region_load",
                                   region=f"{chrom}:{start}-{end}"):
                    loaded.join()  # the wait for cur's reads and assembly
                nxt = next(region_iter, None)
                prefetch = start_prefetch(nxt)
            try:
                state = prepare_region_call(chrom, start, end, bam_files,
                                            samples_by_bam, ref_file, config,
                                            rt, device, preloaded=loaded)
            except DeviceError:
                raise
            except Exception:  # noqa: BLE001 — region crash containment
                logger.exception("Region %s:%s-%s will be skipped",
                                 chrom, start, end)
                state = None
            if state is None:
                done(cur)  # skipped: no output will come
            if not early:
                if prefetch is not None:
                    prefetch.join()  # never leave the helper running into a fetch
                nxt = next(region_iter, None)
                prefetch = start_prefetch(nxt)
            inferring, n = stage(aligning, inferring)
            n_written += n
            aligning = state
            cur = nxt
            index += 1
        if inferring is not None:
            n_written += finish(inferring)
        if aligning is not None and begin(aligning):
            n_written += finish(aligning)
    finally:
        with metrics.timer("run_close"):
            if prefetch is not None:
                prefetch.join()
            if output_path != "-":
                out.close()
            for bam in bam_files:
                bam.close()
            ref_file.close()
    return n_written


def run_hla_regions(config: PlatypusConfig, regions, bam_files,
                    samples_by_bam, ref_file, rt, out, device,
                    done) -> int:
    """--HLATyping=1: every region in order through
    call_hla_variants_in_region, writing to `out`.  A region that fails on
    the host is skipped and logged; a DeviceError stops the run.
    `done(region)` follows each region."""
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


def _cap_worker_threads(n_workers: int) -> None:
    """Split the host's cores between concurrent workers.

    Without this each worker's BLAS and native thread pools span every
    core, so nCPU workers oversubscribe the machine nCPU-fold.  Each
    spawned worker calls this first.
    PLATYPUS_TPU_WORKER_THREADS overrides the split.
    """
    per = os.environ.get("PLATYPUS_TPU_WORKER_THREADS")
    n = int(per) if per else max(1, (os.cpu_count() or 1) // max(1, n_workers))
    # Publish the budget so in-process pools (assembly tiles, native BGZF
    # inflate) size themselves to the worker's share too.
    os.environ["PLATYPUS_TPU_WORKER_THREADS"] = str(n)
    os.environ.setdefault("PLATYPUS_TPU_INFLATE_THREADS", str(n))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(n))


def _n_device_workers(config: PlatypusConfig, n_host: int, device) -> int:
    """How many device workers join the n_host host workers: 0 or 1 (a
    second client of one card would only contend with the first).
    --tpuWorkers and PLATYPUS_TPU_HYBRID_WORKER: 0 off, 1 on.
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


class RegionClaimSource:
    """Work-stealing region source over shared claim state, with RESCUE.

    Every worker holds the same position-sorted region list; claiming is
    one shared index += 1 under its lock, so each worker's claimed regions
    are position-sorted (its temp VCF stays sorted for the k-way merge)
    and regions are processed FIFO exactly like a queue design.

    Hybrid-pool hazard: a device worker's per-region wall can degrade
    (start-up, a contended device), and a claimed-but-unfinished region
    would stall the whole run.  Two defences:

    * BOW-OUT — a device worker only claims while the rest of the pool
      has comfortably more queued work than one of its regions takes
      (remaining > n_host, and its EMA region time <= 0.8 x the time the
      others need to drain what remains, their rate observed from the
      shared index: self-tuning, no cross-process telemetry);
    * RESCUE — once the index is exhausted, host workers re-claim any
      device-claimed-but-uncompleted region (claim_rescue) and call it
      themselves into a dedicated `<output>_rescue_<i>` temp file.
      Output stays byte-identical because every backend produces
      identical data lines (PARITY §15); if the straggler also finishes,
      merge_vcf_files drops the exact-duplicate lines.  The parent
      terminates device workers once every region is completed
      (all_done), so a straggler never extends the run.

    Shared state per region: state 0=unclaimed, 1=host, 2=device,
    3=rescued; completed 0/1 set by mark_done after the region's output
    has been written AND flushed."""

    HOST, DEVICE, RESCUED = 1, 2, 3

    def __init__(self, regions, index, state, completed, n_host: int,
                 is_device: bool = False):
        self.regions = list(regions)
        self.index = index          # multiprocessing.Value('i')
        self.state = state          # multiprocessing.Array('b', N)
        self.completed = completed  # multiprocessing.Array('b', N)
        self.n_host = max(1, n_host)
        self.is_device = is_device
        self._by_region = {tuple(r): i for i, r in enumerate(self.regions)}
        self._ema = None            # my seconds/region
        self._last_claim = None     # (time, index) at my previous claim
        import time as _time

        self._sleep = _time.sleep      # injectable for deterministic tests
        self._now = _time.monotonic    # injectable for deterministic tests

    def __iter__(self):
        if self.is_device and not self._settle_gate():
            return
        while True:
            now = self._now()
            with self.index.get_lock():
                i = self.index.value
                remaining = len(self.regions) - i
                if remaining <= 0:
                    return
                if self.is_device and not self._device_should_claim(
                        i, remaining, now):
                    return
                self.index.value = i + 1
                self.state[i] = self.DEVICE if self.is_device else self.HOST
            if self._last_claim is not None:
                dt = now - self._last_claim[0]
                self._ema = dt if self._ema is None else 0.6 * self._ema + 0.4 * dt
            self._last_claim = (now, i)
            yield self.regions[i]

    def _settle_gate(self) -> bool:
        """First-claim gate for the device consumer: sample the host pool's
        drain rate over a short settle window (the hosts are warm by the
        time the device worker reaches its first claim: its torch import
        and device context take seconds) and claim only if the queue will
        outlast a conservative estimate of the device's FIRST region.  On
        short runs the device worker otherwise claims a region it cannot
        finish before the hosts empty the queue, forcing a rescue and
        net-slowing the run.  Settle window and estimate are env-tunable;
        PLATYPUS_TPU_DEVICE_SETTLE=0 disables the gate."""
        settle = float(os.environ.get("PLATYPUS_TPU_DEVICE_SETTLE", "1.0"))
        if settle <= 0:
            return True
        first_region_est = float(os.environ.get(
            "PLATYPUS_TPU_DEVICE_FIRST_REGION_EST", "25.0"))
        with self.index.get_lock():
            i1 = self.index.value
        t1 = self._now()
        self._sleep(settle)
        with self.index.get_lock():
            i2 = self.index.value
            remaining = len(self.regions) - i2
        dt = self._now() - t1
        if remaining <= self.n_host:
            return False
        if i2 <= i1 or dt <= 0:
            return True  # hosts not draining: no evidence to bow out on
        others_rate = (i2 - i1) / dt
        claim = remaining / others_rate > first_region_est
        if not claim:
            logger.info(
                "device worker: bowing out before first claim (%d regions "
                "remaining, hosts draining %.1f/s -> ~%.0f s left < %.0f s "
                "first-region estimate)", remaining, others_rate,
                remaining / others_rate, first_region_est)
        return claim

    def _device_should_claim(self, i: int, remaining: int, now) -> bool:
        if remaining <= self.n_host:
            return False
        if self._ema is None or self._last_claim is None:
            return True  # first claim is gated by _settle_gate instead
        dt = now - self._last_claim[0]
        claims_by_others = (i - self._last_claim[1]) - 1
        if dt <= 0 or claims_by_others <= 0:
            return True
        others_rate = claims_by_others / dt
        return self._ema <= 0.8 * remaining / others_rate

    def mark_done(self, region) -> None:
        """Record that a region's output is durably written (flushed)."""
        i = self._by_region.get(tuple(region))
        if i is not None:
            self.completed[i] = 1

    def claim_rescue(self):
        """Claim one device-claimed-but-uncompleted region for re-calling
        (host workers, after the main index is exhausted).  Returns
        (region, index) or None."""
        with self.index.get_lock():
            if self.index.value < len(self.regions):
                return None  # mainline work still available
            for i in range(len(self.regions)):
                if self.state[i] == self.DEVICE and not self.completed[i]:
                    self.state[i] = self.RESCUED
                    return self.regions[i], i
        return None

    def all_done(self) -> bool:
        with self.index.get_lock():
            if self.index.value < len(self.regions):
                return False
            return all(self.completed[i] for i in range(len(self.regions)))

    def claim_counts(self):
        """(host, device, rescued) region counts — parent-side summary of
        how much work the hybrid pool's device worker actually kept."""
        with self.index.get_lock():
            states = list(self.state)
        return (states.count(self.HOST), states.count(self.DEVICE),
                states.count(self.RESCUED))


def _worker_entry(config_json: str, source: RegionClaimSource, path: str,
                  service_handle=None) -> int:
    """A spawned host worker: the region pipeline on the host (device
    None) over the regions it claims from the shared index, then the rescue
    pass.  Imports no torch."""
    # Touch the temp file FIRST: the k-way merge must find every worker's
    # temp file.
    open(path, "a").close()
    config = PlatypusConfig.from_json(config_json)
    set_service_handle(service_handle)
    _cap_worker_threads(config.n_cpu)
    # Spawned workers start with a fresh root logger; re-apply the
    # verbosity mapping (the reference's fork model inherited it).
    # continuing=True so a shared log file is appended, not truncated.
    setup_logging(config, continuing=True)
    n = run_single_process(config, source, path, None,
                           on_region_done=source.mark_done)

    # Rescue pass: re-call any device-claimed region whose output never
    # became durable, each into its own `<output>_rescue_<i>` file
    # (trivially sorted; the parent merges them in).  Duplicate lines from
    # a straggler that finished anyway are dropped at merge time.
    while True:
        rescue = source.claim_rescue()
        if rescue is None:
            break
        region, r_idx = rescue
        logger.info("Rescuing region %s:%s-%s from the device worker",
                    *region)
        n += run_single_process(config, [region],
                                f"{config.output}_rescue_{r_idx}", None,
                                on_region_done=source.mark_done)
    return n


def _delayed_regions(regions, delay: float):
    import time as _time

    for region in regions:
        _time.sleep(delay)
        yield region


def _crash_after_first_claim(regions):
    """Test hook: claim one region, then die hard (os._exit skips crash
    containment) — the parent must treat the rescued run as complete."""
    for _region in regions:
        os._exit(17)


def _device_counts() -> Tuple[str, ...]:
    """What the device worker reports back through its shared counter
    array: regions it finished (written or skipped), launches per kernel
    library and fused-inference batches, all counted in its own process
    (its GLOBAL_METRICS counters launches.<library> and k3_batches)."""
    from ..ops import align_cuda

    return ("regions", *align_cuda.KERNELS, "batches")


def _device_worker_entry(config_json: str, source: RegionClaimSource,
                         path: str, device, counts) -> None:
    """A spawned device worker: run_single_process on `device` over the
    regions it claims from the shared index.  After each region it stores
    its counts (_device_counts) in the shared `counts` array, then marks
    the region durable."""
    import torch

    from ..ops import align_cuda

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
    # lock unwinds through its `with` block instead of dying inside the
    # critical section and poisoning the shared semaphore.
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
    names = _device_counts()

    def on_done(region) -> None:
        nonlocal n_done
        n_done += 1
        values = dict(align_cuda.launches(), regions=n_done,
                      batches=metrics.counters["k3_batches"])
        for k, name in enumerate(names):
            counts[k] = values[name]
        source.mark_done(region)

    run_single_process(config, regions, path, device, on_region_done=on_done)


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


def run_pool(config: PlatypusConfig, regions: List[Region], device) -> dict:
    """The n_cpu > 1 run: spawned host workers, at most one device worker
    or the inference service, the parent's watch loop, then the k-way
    merge into config.output.  Returns the pool's summary: claim counts,
    and the device worker's _device_counts."""
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
    names = _device_counts()
    counts = ctx.Array("q", len(names))
    parent_source = RegionClaimSource(regions, claim_index, claim_state,
                                      claim_completed, n_host)

    def source(is_device: bool) -> RegionClaimSource:
        return RegionClaimSource(regions, claim_index, claim_state,
                                 claim_completed, n_host, is_device=is_device)

    # A host worker has no device: its --deviceInference=1 means the
    # service, and it aligns natively whatever --meshDevices says.
    host_config = PlatypusConfig.from_json(config.to_json())
    if host_config.device_inference == 1:
        host_config.device_inference = -1
    host_config.mesh_devices = 0
    workers = [ctx.Process(target=_worker_entry,
                           args=(host_config.to_json(), source(False),
                                 temp_files[i],
                                 service.handle_for(i) if service else None),
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
            proc.start()
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
                   **dict(zip(names, counts[:])))
    logger.info("pool: %s", json.dumps(summary))
    merge_vcf_files(temp_files + sorted(glob.glob(f"{config.output}_rescue_*")),
                    config.output)
    return summary


def run_variant_caller(config: PlatypusConfig, device,
                       regions: Optional[List[Region]] = None,
                       continuing: bool = False) -> Optional[dict]:
    """`callVariants` on `device`: with --distributed, this process's
    share of a multi-host run (parallel/distributed.run_distributed);
    else one process for n_cpu <= 1 (appending when `continuing`; under
    observability.trace("callVariants") when PLATYPUS_TPU_TRACE_DIR is
    set), or run_pool, whose summary it returns."""
    setup_logging(config, continuing)
    if config.distributed:
        from ..parallel.distributed import run_distributed, shutdown

        run_distributed(config, device)
        shutdown()
        return None
    if regions is None:
        regions = get_regions(config)
    regions = sorted(regions, key=lambda r: (_chrom_sort_key(r[0]), r[1], r[2]))
    if config.n_cpu <= 1:
        with trace("callVariants"):
            run_single_process(config, regions, config.output, device,
                               append=continuing)
        return None
    return run_pool(config, regions, device)


def _chrom_sort_key(chrom: str):
    try:
        return (0, int(chrom.upper().strip("CHR")), "")
    except Exception:  # noqa: BLE001
        return (1, 0, chrom)


def merge_vcf_files(temp_files: Sequence[str], final_name: str) -> None:
    """k-way merge of sorted temp VCFs (runner.py:301-352).

    Hybrid-pool hardening: (a) a line without a trailing newline (a device
    straggler terminated mid-write) is dropped — its region has a complete
    rescue copy; (b) an exact-duplicate line at the same (chrom, pos) is
    emitted once (the straggler finished AND the rescuer re-called the
    region; both copies are byte-identical by the determinism contract)."""
    out = sys.stdout if final_name == "-" else open(final_name, "w")
    heap = []

    def data_lines(fh):
        # A line without its trailing newline is a mid-write truncation —
        # only possible as a file's last line (a terminated straggler) —
        # and is dropped BEFORE keying: a truncated line can be cut inside
        # its first two columns, where _line_key would raise.  Its region
        # has a complete rescue copy.
        for line in fh:
            if line.endswith("\n"):
                yield line

    for index, name in enumerate(temp_files):
        fh = open(name)
        first_data = None
        for line in fh:
            if line.startswith("#"):
                if index == 0:
                    out.write(line)
            else:
                if line.endswith("\n"):
                    first_data = line
                break
        if first_data is None:
            fh.close()
            os.remove(name)
            continue
        g = data_lines(fh)
        heapq.heappush(heap, (_line_key(first_data), index, first_data, g, fh, name))

    cur_key = None
    cur_lines: set = set()
    while heap:
        _key, index, line, g, fh, name = heapq.heappop(heap)
        pos_key = _key[:2]
        if pos_key != cur_key:
            cur_key = pos_key
            cur_lines.clear()
        if line not in cur_lines:
            cur_lines.add(line)
            out.write(line)
        try:
            nxt = next(g)
            heapq.heappush(heap, (_line_key(nxt), index, nxt, g, fh, name))
        except StopIteration:
            fh.close()
            os.remove(name)
    if final_name != "-":
        out.close()


def _line_key(line: str):
    cols = line.split("\t", 2)
    return (_chrom_sort_key(cols[0]), int(cols[1]))


def setup_logging(config: PlatypusConfig, continuing: bool = False) -> None:
    """Console + log-file handlers with the reference's verbosity mapping
    (runner.py:404-439): console ERROR/WARNING/INFO for verbosity 0/1/>=2,
    file always DEBUG, appended on resume."""
    root = logging.getLogger()
    # DEBUG only matters when a file handler is attached (file gets DEBUG,
    # console is gated per verbosity); INFO otherwise keeps third-party
    # debug chatter out.
    root.setLevel(logging.DEBUG if config.log_file_name else logging.INFO)
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    for h in list(root.handlers):
        root.removeHandler(h)
    ch = logging.StreamHandler()
    ch.setFormatter(formatter)
    ch.setLevel({0: logging.ERROR, 1: logging.WARNING}.get(
        int(config.verbosity), logging.INFO))
    root.addHandler(ch)
    if config.log_file_name:
        try:
            fh = logging.FileHandler(config.log_file_name,
                                     "a" if continuing else "w")
            fh.setFormatter(formatter)
            fh.setLevel(logging.DEBUG)
            root.addHandler(fh)
        except OSError:
            logger.warning("Could not open log file %s", config.log_file_name)


def _config_from_reference_header(text: str) -> PlatypusConfig:
    """Parse the REFERENCE's platypusOptions header (py2 dict repr with
    option-dest keys) into a PlatypusConfig, so a crashed run of the
    original Platypus can be resumed by this caller (migration path).
    Unknown reference-only keys are ignored; camelCase keys map through
    the CLI flag table."""
    from ..cli import _FLAG_MAP

    d = ast.literal_eval(text)
    fields = {f.name for f in dataclasses.fields(PlatypusConfig)}
    extra = {"rlen": "rlen", "sourceFile": "source_file", "output": "output"}

    def snake(k: str) -> str:
        return re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower()

    kw = {}
    for k, v in d.items():
        f = _FLAG_MAP.get(k) or extra.get(k) or snake(k)
        if f not in fields or v is None:
            continue
        if f in ("source_file", "bam_files", "regions") and isinstance(v, str):
            v = [v]
        kw[f] = v
    return PlatypusConfig(**kw)


def continue_calling(vcf_path: str, device) -> None:
    """Resume an interrupted single-process run from its partial VCF
    (runner.py:197-297): re-call from the region holding the last written
    record into `<vcf>_ContinuedFromFailedProcess.vcf`, which keeps the
    completed lines before it.  Accepts this caller's JSON options header
    or the reference's py2 dict-repr header."""
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
