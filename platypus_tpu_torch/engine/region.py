"""Region pipeline stages of the torch port: prepare -> begin -> finish.

Twins of platypus_tpu/engine/region.py's prepare_region_call,
begin_region_inference and finish_region_call, with the --meshDevices
branch (parallel/mesh.py) and without the device-service client's.  The
host work (read loading and
QC, candidate generation, windowing, and the per-window output loop) is
the JAX package's code.  The host-side crash containment of a region load
and of a window's preparation stays as it is there.  Every device stage
(the alignment dispatch, its finalize, the fused inference's dispatch and
its gather) runs inside device_stage, so whatever it raises leaves as
DeviceError, which the window containment here and the runner's region
containment re-raise.  The beam search's device scoring runs inside a
window's preparation and raises DeviceError too.  Unlike the JAX package,
a failed mesh stage does not fall back to the dispatch path.
"""

from __future__ import annotations

import logging
import time
from typing import Sequence

import torch

from platypus_tpu.candidates.windows import generate_windows
from platypus_tpu.config import PlatypusConfig, RuntimeState
from platypus_tpu.engine import region as host_region
from platypus_tpu.engine.region import (PreparedRegion, RegionPrefetch,
                                        generate_variants_in_region,
                                        load_region_buffers)
from platypus_tpu.engine.score import RegionReadMatrix, fill_deferred_pairs
from platypus_tpu.io.bam import BamFile
from platypus_tpu.utils.observability import GLOBAL_METRICS as metrics

from ..parallel.batch import dispatch_device_inference
from ..parallel.mesh import get_engine_mesh, mesh_call_region
from ..utils.backend import DeviceError, device_stage
from .caller import prepare_window
from .score import dispatch_alignment_requests, run_alignment_requests

logger = logging.getLogger("platypus_tpu")


def prepare_region_call(
    chrom: str,
    start: int,
    end: int,
    bam_files: Sequence[BamFile],
    samples_by_bam,
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device: torch.device,
    preloaded: RegionPrefetch = None,
):
    """Host phases of a region (load, candidates, window prep) ending with
    the asynchronous dispatch of all its alignments on `device` (with
    --meshDevices, none: the mesh aligns in begin_region_inference).
    Returns None when the region is skipped, else a PreparedRegion."""
    rlen0 = rt.rlen
    region_t0 = time.perf_counter()
    ref_file.set_cache_sequence(chrom, start - 10 * rt.rlen, end + 10 * rt.rlen)
    contig_len = ref_file.refs[chrom].length
    max_contig_pos = contig_len - 1

    try:
        with metrics.timer("region_load"):
            if preloaded is not None and preloaded.matches(chrom, start, end):
                buffers = preloaded.result()
            else:
                buffers = load_region_buffers(bam_files, samples_by_bam, chrom,
                                              start, end, config)
    except Exception as exc:  # noqa: BLE001 — region-level crash containment
        logger.exception("Exception loading region %s:%s-%s: %s", chrom, start, end, exc)
        return None
    if buffers is None:
        logger.info("Skipping region %s:%s-%s (data could not be loaded)", chrom, start, end)
        return None

    for buf in buffers:
        metrics.count("reads", len(buf.good) + len(buf.bad))
        if config.verbosity >= 3:
            logger.info("sample %s: %d good, %d bad, %d broken; filters %s",
                        buf.sample, len(buf.good), len(buf.bad), len(buf.broken),
                        buf.filter_counts)
    with metrics.timer("candidate_generation"):
        variants = generate_variants_in_region(chrom, start, end, ref_file, buffers, config, rt)
    # Re-cache with the updated read length.
    if rt.rlen != rlen0:
        ref_file.set_cache_sequence(chrom, start - 10 * rt.rlen, end + 10 * rt.rlen)

    if config.compress_reads:
        # Memory mode of --compressReads (region.py:395-413).
        comp_start = max(0, start - 10 * rt.rlen)
        comp_end = min(contig_len, end + 10 * rt.rlen)
        ref_bytes = ref_file.get_sequence(chrom, comp_start, comp_end)
        for buf in buffers:
            for rs in (buf.good, buf.bad):
                if len(rs) and rs.seq is not None and rs.seq.size:
                    rs.compress_in_memory(ref_bytes, comp_start)

    windows = list(generate_windows(
        chrom, start, end, max_contig_pos, variants,
        rlen=rt.rlen, max_size=config.max_size,
        large_windows=bool(config.large_windows),
        max_var_dist=config.max_var_dist, min_var_dist=config.min_var_dist,
        max_variants=config.max_variants,
        merge_clustered=bool(config.merge_clustered_variants),
        output_ref_calls=bool(config.output_ref_calls),
        ref_call_block_size=config.ref_call_block_size,
    ))

    # Phase 1 (host): haplotype enumeration + pair construction per window.
    win_bounds = [(w.start_pos, w.end_pos) for w in windows
                  if w.variants and w.end_pos - w.start_pos <= config.max_size]
    region_reads = (RegionReadMatrix.build(buffers)
                    if win_bounds and not config.compress_reads else None)
    for buf in buffers:
        buf.precompute_window_slices(win_bounds)
    prepared = {}
    prep_t0 = time.perf_counter()
    for w_idx, window in enumerate(windows):
        if not window.variants:
            continue
        if window.end_pos - window.start_pos > config.max_size:
            logger.info(
                "Skipping very large window %s:%s-%s", chrom, window.start_pos, window.end_pos
            )
            prepared[w_idx] = "skip"
            continue
        try:
            prepared[w_idx] = prepare_window(window, buffers, ref_file, config, rt,
                                             device, region_reads=region_reads,
                                             defer_pairs=True)
        except DeviceError:
            raise  # the beam search's device work is not contained
        except Exception:  # noqa: BLE001 — window crash containment
            logger.exception(
                "Exception preparing window %s:%s-%s", chrom, window.start_pos, window.end_pos
            )
            prepared[w_idx] = "skip"

    metrics.timers["window_prepare"] += time.perf_counter() - prep_t0

    # Phase 2 (device): dispatch every window's alignments in a few big
    # batched calls; results are awaited in begin_region_inference.
    live = [(w_idx, p) for w_idx, p in prepared.items() if p not in (None, "skip")]
    prep_t1 = time.perf_counter()
    fill_deferred_pairs([p.request for _, p in live])
    metrics.timers["window_prepare"] += time.perf_counter() - prep_t1
    metrics.count("windows", len(windows))
    metrics.count("alignment_pairs",
                  sum(p.request.n_pairs() for _, p in live if p.request is not None))
    if config.mesh_devices:
        pending = None
    else:
        with metrics.timer("device_dispatch"), device_stage(
                f"alignment dispatch of {chrom}:{start}-{end} on {device}"):
            pending = dispatch_alignment_requests([p.request for _, p in live],
                                                  device)

    return PreparedRegion(chrom=chrom, start=start, end=end, buffers=buffers,
                          windows=windows, prepared=prepared, live=live,
                          pending=pending, region_t0=region_t0)


def device_inference_enabled(config: PlatypusConfig, device: torch.device) -> bool:
    """--deviceInference: 0 = host float64 path, 1 = fused device path,
    -1 (auto) = on when the run's device is CUDA."""
    if config.device_inference == -1:
        return device.type == "cuda"
    return bool(config.device_inference)


def begin_region_inference(state, config: PlatypusConfig,
                           device: torch.device) -> None:
    """Await the region's alignment scores and queue the fused
    GL/EM/posterior programs without waiting for them; with
    --meshDevices, queue the mesh's region step instead (its fetch is left
    in state.mesh_fetch for finish_region_call) and align the pair-less
    windows it leaves over.  Idempotent; finish_region_call calls it if
    the runner has not."""
    if state.loglik_by_idx is not None or state.mesh_fetch is not None:
        return
    where = f"{state.chrom}:{state.start}-{state.end} on {device}"
    if state.pending is None:
        with metrics.timer("device_alignment"), device_stage(
                f"mesh region step of {where}"):
            mesh = get_engine_mesh(config.mesh_devices, device)
            fetch_fn, leftover = mesh_call_region(
                state.live, len(state.buffers), mesh, defer=True)
        extra = {}
        if leftover:
            with metrics.timer("device_alignment"):
                lls = run_alignment_requests([p.request for _, p in leftover],
                                             device)
            extra = {w_idx: ll for (w_idx, _p), ll in zip(leftover, lls)}
        state.mesh_fetch = (fetch_fn, extra)
        return
    with metrics.timer("device_alignment"), device_stage(
            f"alignment of {where}"):
        logliks = state.pending.finalize()
    state.loglik_by_idx = {w_idx: ll
                           for (w_idx, _p), ll in zip(state.live, logliks)}
    state.inference_by_idx = {}
    if device_inference_enabled(config, device):
        with metrics.timer("device_inference"), device_stage(
                f"inference dispatch of {where}"):
            state.pending_inference = dispatch_device_inference(
                state.live, state.loglik_by_idx, len(state.buffers), device)


def finish_region_call(state, ref_file, config: PlatypusConfig, writer,
                       device: torch.device) -> int:
    """Await the region's device results, then run the JAX package's host
    per-window inference + output (in window order).  Returns the number
    of VCF lines written."""
    begin_region_inference(state, config, device)
    if state.mesh_fetch is not None:
        fetch_fn, extra = state.mesh_fetch
        with metrics.timer("device_alignment"), device_stage(
                f"mesh fetch of {state.chrom}:{state.start}-{state.end} "
                f"on {device}"):
            state.loglik_by_idx, state.inference_by_idx = fetch_fn()
        state.loglik_by_idx.update(extra)
        state.mesh_fetch = None
    if state.pending_inference is not None:
        with metrics.timer("device_inference"), device_stage(
                f"inference of {state.chrom}:{state.start}-{state.end} "
                f"on {device}"):
            state.inference_by_idx = state.pending_inference.gather()
        state.pending_inference = None
    # Every device stage is done: the JAX package's finish sees a region
    # whose log-likelihoods and inference results are already on the host.
    return host_region.finish_region_call(state, ref_file, config, writer)
