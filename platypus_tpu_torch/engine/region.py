"""Region-level orchestration: load reads, generate candidates, window loop.

Equivalent of the reference's callVariantsInRegion / generateVariantsInRegion
(variantcaller.pyx:412-615) and loadBAMData (platypusutils.pyx:449-687):
per 100kb region, reads are fetched per sample and QC'd into buffers,
candidates come from CIGARs (plus optional source VCF and assembler), get
left-normalised, merged and support-filtered, then clustered into windows
which are called and written out.

A region runs in three stages, prepare -> begin -> finish, so the runner
can overlap one region's device work with the next one's host work
(call_variants_in_region runs them back to back).  On a
torch device every device stage (the alignment dispatch, its finalize, the
fused inference's dispatch and its gather, and with --meshDevices the
mesh's region step, parallel/mesh.py) runs inside device_stage, so
whatever it raises leaves as DeviceError, which the window containment
here and the runner's region containment re-raise; the beam search's
device scoring runs inside a window's preparation and raises DeviceError
too.  A failure on the host is logged and the window or region skipped,
mirroring the reference's crash containment (variantcaller.pyx:613-615).

With `device` None (the host path of a pool's host worker) alignment is
native, inference is float64 on the host or, when the pool runs the
device-owner service, that service's (engine/device_service.py); torch is
never imported.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..candidates.cigar_gen import CandidateGenerator
from ..candidates.filters import filter_variants
from ..candidates.normalize import left_normalise_indel
from ..candidates.variant import Variant
from ..candidates.windows import Window, generate_windows
from ..config import PlatypusConfig, RuntimeState
from ..io.bam import BamFile
from ..io.readbuffer import QCOptions, SampleReadBuffer, build_sample_buffer
from ..parallel.batch import dispatch_device_inference
from ..utils.backend import DeviceError, device_stage
from ..utils.observability import GLOBAL_METRICS as metrics
from ..vcfout.records import output_call_to_vcf
from ..vcfout.refcalls import output_ref_call
from .caller import finish_window, precompute_window_gl, prepare_window
from .device_service import dispatch_service_inference, get_inference_client
from .score import (RegionReadMatrix, dispatch_alignment_requests,
                    fill_deferred_pairs, run_alignment_requests)

logger = logging.getLogger("platypus_tpu")

def qc_options_from_config(config: PlatypusConfig) -> QCOptions:
    return QCOptions(
        min_map_qual=config.min_map_qual,
        min_base_qual=config.min_base_qual,
        min_good_qual_bases=config.min_good_qual_bases,
        min_flank=config.min_flank,
        trim_read_flank=config.trim_read_flank,
        trim_overlapping=config.trim_overlapping,
        trim_adapter=config.trim_adapter,
        trim_soft_clipped=config.trim_soft_clipped,
        filter_duplicates=config.filter_duplicates,
        filter_reads_with_unmapped_mates=config.filter_reads_with_unmapped_mates,
        filter_reads_with_distant_mates=config.filter_reads_with_distant_mates,
        filter_read_pairs_with_small_inserts=config.filter_read_pairs_with_small_inserts,
    )


def load_region_buffers(
    bam_files: Sequence[BamFile],
    samples_by_bam: Dict[BamFile, List[str]],
    chrom: str,
    start: int,
    end: int,
    config: PlatypusConfig,
) -> Optional[List[SampleReadBuffer]]:
    """Fetch + QC reads for one region, one buffer per sample, sorted by
    sample name (platypusutils.pyx:449-687).  Returns None when the region
    exceeds maxReads.  Timed as `bam_decode` on whichever thread runs it:
    the prefetch helper, or the pipeline inside `region_load`."""
    with metrics.timer("bam_decode", region=f"{chrom}:{start}-{end}"):
        qc = qc_options_from_config(config)
        buffers = []
        total_reads = 0
        multi = any(len(s) > 1 for s in samples_by_bam.values())
        if not multi:
            for bam in bam_files:
                sample = samples_by_bam[bam][0]
                stream = bam.fetch(chrom, start, end)
                total_reads += len(stream)
                if total_reads >= config.max_reads:
                    logger.warning(
                        "Too many reads (%s) in region %s:%s-%s", total_reads, chrom, start, end
                    )
                    return None
                broken = None
                if config.assemble_broken_pairs:
                    broken = _fetch_broken_mates(bam, stream, chrom, start, end)
                buf = build_sample_buffer(sample, stream, qc, broken)
                if config.compress_reads and config.qual_bin_size > 1:
                    # The lossy part of --compressReads (quality binning) is
                    # applied post-QC, matching the reference's observable
                    # behaviour (htslibWrapper.pyx:505-507; io/compression.py).
                    from ..io.compression import apply_qual_binning

                    for rs in (buf.good, buf.bad, buf.broken):
                        apply_qual_binning(rs, config.qual_bin_size)
                buffers.append(buf)
        else:
            # Multi-sample BAMs: split the stream by RG tag.
            streams: Dict[str, list] = {}
            sample_by_rg: Dict[bytes, str] = {}
            for bam in bam_files:
                for rg in bam.header_dict().get("RG", []):
                    if "ID" in rg and "SM" in rg:
                        sample_by_rg[rg["ID"].encode()] = rg["SM"]
            all_samples = sorted({s for ss in samples_by_bam.values() for s in ss})
            per_sample_subsets: Dict[str, list] = {s: [] for s in all_samples}
            for bam in bam_files:
                rs = bam.fetch(chrom, start, end, store_rg=True)
                total_reads += len(rs)
                if total_reads >= config.max_reads:
                    return None
                samples_arr = np.array([
                    sample_by_rg.get(rs.rg_id[i] if rs.rg_id else None, all_samples[0])
                    for i in range(len(rs))
                ]) if len(rs) else np.zeros(0, dtype=object)
                for sample in all_samples:
                    idx = np.nonzero(samples_arr == sample)[0]
                    if len(idx):
                        per_sample_subsets[sample].append(rs.take(idx))
            from ..io.bam import empty_read_set

            for sample in all_samples:
                stream = _concat_read_sets(per_sample_subsets[sample])
                buffers.append(build_sample_buffer(sample, stream, qc))
        buffers.sort(key=lambda b: b.sample)
        return buffers


def _fetch_broken_mates(bam: BamFile, stream, chrom: str, start: int, end: int):
    """Fetch the mates of broken pairs (not proper / mate unmapped) whose
    mate maps back into this region (platypusutils.pyx:522-559,690-707)."""
    from ..io.bam import FLAG_MUNMAP, FLAG_PAIRED, FLAG_PROPER_PAIR, FLAG_UNMAP, empty_read_set

    flags = stream.flag
    is_broken = ((flags & FLAG_PROPER_PAIR) == 0) | ((flags & FLAG_UNMAP) != 0) | (
        (flags & FLAG_MUNMAP) != 0
    )
    same_chrom = stream.mate_chrom_id == stream.chrom_id
    coords = np.sort(stream.mate_pos[is_broken & same_chrom])
    if len(coords) == 0:
        return empty_read_set()
    # Merge single-position queries into spans (mergeQueries semantics).
    queries = []
    for pos in coords:
        pos = int(pos)
        if queries and pos - queries[-1][1] < 1e4 and pos - queries[-1][0] < 1e5:
            queries[-1][1] = pos + 1
        else:
            queries.append([pos, pos + 1])
    pieces = []
    for q_start, q_end in queries:
        rs = bam.fetch(chrom, q_start, q_end)
        keep = (rs.mate_chrom_id == rs.chrom_id) & (rs.mate_pos >= start) & (rs.mate_pos <= end)
        idx = np.nonzero(keep)[0]
        if len(idx):
            pieces.append(rs.take(idx))
    return _concat_read_sets(pieces)


def _concat_read_sets(subsets):
    from ..io.bam import ReadSet, empty_read_set

    if not subsets:
        return empty_read_set()
    L = max(rs.seq.shape[1] for rs in subsets)
    n = sum(len(rs) for rs in subsets)
    out = empty_read_set(L)
    seq = np.zeros((n, L), np.uint8)
    qual = np.zeros((n, L), np.uint8)
    row = 0
    scalars = {k: [] for k in ("rlen", "pos", "end", "mapq", "flag", "chrom_id",
                               "mate_chrom_id", "mate_pos", "insert_size", "qc_fail")}
    cigars = []
    for rs in subsets:
        k = len(rs)
        seq[row : row + k, : rs.seq.shape[1]] = rs.seq
        qual[row : row + k, : rs.qual.shape[1]] = rs.qual
        for key in scalars:
            scalars[key].append(getattr(rs, key))
        for i in range(k):
            cigars.append(rs.cigar_flat[rs.cigar_off[i] : rs.cigar_off[i + 1]])
        row += k
    lens = np.array([len(c) for c in cigars], dtype=np.int64)
    return ReadSet(
        seq=seq, qual=qual,
        rlen=np.concatenate(scalars["rlen"]),
        pos=np.concatenate(scalars["pos"]),
        end=np.concatenate(scalars["end"]),
        mapq=np.concatenate(scalars["mapq"]),
        flag=np.concatenate(scalars["flag"]),
        chrom_id=np.concatenate(scalars["chrom_id"]),
        mate_chrom_id=np.concatenate(scalars["mate_chrom_id"]),
        mate_pos=np.concatenate(scalars["mate_pos"]),
        insert_size=np.concatenate(scalars["insert_size"]),
        cigar_flat=np.concatenate(cigars) if cigars else np.zeros(0, np.uint32),
        cigar_off=np.concatenate([[0], np.cumsum(lens)]),
        qc_fail=np.concatenate(scalars["qc_fail"]),
    )


def generate_variants_in_region(
    chrom: str,
    start: int,
    end: int,
    ref_file,
    buffers: Sequence[SampleReadBuffer],
    config: PlatypusConfig,
    rt: RuntimeState,
    assembled: Optional[List[Variant]] = None,
) -> List[Variant]:
    """Candidate generation for one region (variantcaller.pyx:412-527).

    With --assemble=1, `assembled` holds the region's assembler variants
    when the prefetch helper made them (RegionPrefetch); None assembles
    them here."""
    raw_bam_variants: List[Variant] = []
    vcf_file_variants: List[Variant] = []
    assembler_variants: List[Variant] = []
    longest_read = 0

    if config.get_variants_from_bams:
        # Per-sample tuple counts -> per-sample min-VAF gate
        # (variantcaller.pyx:457-468) -> cross-sample merged counts; Variant
        # objects are constructed once, for the merged survivors only.
        merged: dict = {}
        merged_gen = None
        for buf in buffers:
            gen = CandidateGenerator(
                (chrom, start, end), ref_file, config.min_map_qual, config.min_flank,
                config.min_base_qual, config.gen_snps, config.gen_indels,
            )
            merged_gen = gen
            if len(buf.good):
                longest_read = max(longest_read, int((buf.good.end - buf.good.pos).max()))
            gen.add_candidates_from_reads(buf.good, range(len(buf.good)))
            keys = list(gen.counts)
            if keys:
                counts = buf.count_reads_covering_positions(
                    np.fromiter((k[0] for k in keys), np.int64, count=len(keys))
                )
                for k, c in zip(keys, counts):
                    support = gen.counts[k]
                    frac = support / c if c else 0.0
                    if frac >= config.min_var_freq or len(k[1]) != len(k[2]):
                        merged[k] = merged.get(k, 0) + support
        if merged_gen is not None:
            merged_gen.counts = merged
            # SNP singletons can't gain support downstream unless another
            # candidate source can contribute an equal variant.
            pre_drop = (config.min_reads
                        if not config.source_file and not config.assemble else 1)
            raw_bam_variants.extend(merged_gen.get_candidates(pre_drop))

        # rlen tracks the longest observed read (variantcaller.pyx:478-487).
        if longest_read > 0:
            if longest_read >= config.max_size:
                rt.rlen = config.max_size
            else:
                rt.rlen = longest_read

    if config.source_file:
        from ..io.vcfsource import VariantCandidateReader

        reader = VariantCandidateReader(config.source_file, long_haps=bool(config.long_haps))
        vcf_file_variants.extend(reader.variants(chrom, start, end))

    if config.assemble:
        if assembled is None:
            from ..candidates.assembly import assemble_region_variants

            with metrics.timer("assembly"):
                assembled = assemble_region_variants(chrom, start, end,
                                                     ref_file, buffers, config)
        else:
            metrics.count("assembly_prefetched")
        assembler_variants.extend(assembled)

    all_cands = raw_bam_variants + vcf_file_variants + assembler_variants
    left_norm = sorted(
        (left_normalise_indel(v, ref_file, rt.rlen) for v in all_cands),
        key=lambda v: v.sort_key(),
    )
    return filter_variants(left_norm, config.min_reads, config.min_reads, config.max_size)


class PreparedRegion:
    """Host-side state of a region whose device alignments are in flight."""

    __slots__ = ("chrom", "start", "end", "buffers", "windows", "prepared",
                 "live", "pending", "loglik_by_idx",
                 "pending_inference", "inference_by_idx", "mesh_fetch")

    def __init__(self, **kw):
        self.loglik_by_idx = None        # set by begin_region_inference
        self.pending_inference = None
        self.inference_by_idx = None
        self.mesh_fetch = None           # deferred mesh fetch (closure, extra)
        for k, v in kw.items():
            setattr(self, k, v)

    def release(self) -> None:
        """Drop everything but the region's coordinates, so that its reads,
        windows and results are freed now and not wherever the last
        reference to the state happens to go."""
        for name in self.__slots__[3:]:
            setattr(self, name, None)


def call_variants_in_region(
    chrom: str,
    start: int,
    end: int,
    bam_files: Sequence[BamFile],
    samples_by_bam,
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    writer,
    device,
) -> int:
    """Full region pipeline on `device` (None: the host path); returns the
    number of VCF lines written."""
    state = prepare_region_call(chrom, start, end, bam_files, samples_by_bam,
                                ref_file, config, rt, device)
    if state is None:
        return 0
    return finish_region_call(state, ref_file, config, writer, device)


class RegionPrefetch:
    """The NEXT region's BAM decode, and with --assemble=1 its local
    assembly, on a helper thread.

    The native reader releases the GIL for the whole fetch, and the native
    assembler for its whole tile loop, so region k+1's decode and assembly
    genuinely overlap region k's host work and device waits.  The assembly
    is the span `assembly` beside `bam_decode`, not inside it; it reads the
    reference through `ref_file`'s get_sequence, which is safe beside the
    pipeline's own reads (io/fasta.py), and never sets its region cache.
    The runner guarantees the thread is the only BAM user while it runs
    (it joins before any other fetch)."""

    def __init__(self, bam_files, samples_by_bam, chrom, start, end, config,
                 ref_file):
        import threading

        self.chrom, self.start, self.end = chrom, start, end
        self._box = {}

        def work():
            try:
                buffers = self._box["buffers"] = load_region_buffers(
                    bam_files, samples_by_bam, chrom, start, end, config)
                if config.assemble and buffers is not None:
                    from ..candidates.assembly import assemble_region_variants

                    with metrics.timer("assembly",
                                       region=f"{chrom}:{start}-{end}"):
                        self._box["assembled"] = assemble_region_variants(
                            chrom, start, end, ref_file, buffers, config)
            except BaseException as exc:  # noqa: BLE001 — re-raised in result()
                self._box["exc"] = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def matches(self, chrom, start, end) -> bool:
        return (chrom, start, end) == (self.chrom, self.start, self.end)

    def join(self) -> None:
        self._thread.join()

    def result(self):
        """(buffers, assembler variants or None), once the thread ends;
        what the thread raised is raised here."""
        self._thread.join()
        if "exc" in self._box:
            raise self._box["exc"]
        return self._box["buffers"], self._box.get("assembled")


def prepare_region_call(
    chrom: str,
    start: int,
    end: int,
    bam_files: Sequence[BamFile],
    samples_by_bam,
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device,
    preloaded: RegionPrefetch = None,
):
    """Host phases of a region (load, candidates, window prep) ending with
    the asynchronous dispatch of all its alignments on `device` (with
    --meshDevices, none: the mesh aligns in begin_region_inference).
    Returns None when the region is skipped, else a PreparedRegion.

    The prepare(k+1) / finish(k) split lets the runner overlap region k's
    in-flight device pass and result transfer with region k+1's host work
    (SURVEY section 2.5)."""
    with metrics.timer("region_prepare", region=f"{chrom}:{start}-{end}"):
        rlen0 = rt.rlen
        _cache_reference(ref_file, chrom, start - 10 * rt.rlen,
                         end + 10 * rt.rlen)
        contig_len = ref_file.refs[chrom].length
        max_contig_pos = contig_len - 1

        try:
            with metrics.timer("region_load"):
                if preloaded is not None and preloaded.matches(chrom, start,
                                                               end):
                    buffers, assembled = preloaded.result()
                else:
                    assembled = None
                    buffers = load_region_buffers(bam_files, samples_by_bam,
                                                  chrom, start, end, config)
        except Exception as exc:  # noqa: BLE001 — region-level crash containment
            logger.exception("Exception loading region %s:%s-%s: %s", chrom,
                             start, end, exc)
            return None
        if buffers is None:
            logger.info("Skipping region %s:%s-%s (data could not be loaded)",
                        chrom, start, end)
            return None

        for buf in buffers:
            metrics.count("reads", len(buf.good) + len(buf.bad))
            for name, n in buf.filter_counts.items():
                metrics.count("reads_filtered." + name, n)
            for name, n in buf.trimmed.items():
                metrics.count("reads_trimmed_" + name, n)
            if config.verbosity >= 3:
                logger.info("sample %s: %d good, %d bad, %d broken; filters %s",
                            buf.sample, len(buf.good), len(buf.bad),
                            len(buf.broken), buf.filter_counts)
        with metrics.timer("candidate_generation"):
            variants = generate_variants_in_region(chrom, start, end, ref_file,
                                                   buffers, config, rt,
                                                   assembled=assembled)
        # Re-cache with the updated read length.
        if rt.rlen != rlen0:
            _cache_reference(ref_file, chrom, start - 10 * rt.rlen,
                             end + 10 * rt.rlen)

        with metrics.timer("window_layout"):
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
                max_var_dist=config.max_var_dist,
                min_var_dist=config.min_var_dist,
                max_variants=config.max_variants,
                merge_clustered=bool(config.merge_clustered_variants),
                output_ref_calls=bool(config.output_ref_calls),
                ref_call_block_size=config.ref_call_block_size,
            ))

            # Phase 1 (host): haplotype enumeration + pair construction per
            # window.
            win_bounds = [(w.start_pos, w.end_pos) for w in windows
                          if w.variants
                          and w.end_pos - w.start_pos <= config.max_size]
            region_reads = (RegionReadMatrix.build(buffers)
                            if win_bounds and not config.compress_reads
                            else None)
            for buf in buffers:
                buf.precompute_window_slices(win_bounds)
        prepared = {}
        with metrics.timer("window_prepare"), metrics.timer("haplotypes"):
            for w_idx, window in enumerate(windows):
                if not window.variants:
                    continue
                if window.end_pos - window.start_pos > config.max_size:
                    logger.info("Skipping very large window %s:%s-%s", chrom,
                                window.start_pos, window.end_pos)
                    prepared[w_idx] = "skip"
                    continue
                try:
                    prepared[w_idx] = prepare_window(
                        window, buffers, ref_file, config, rt, device,
                        region_reads=region_reads, defer_pairs=True)
                except DeviceError:
                    raise  # the beam search's device work is not contained
                except Exception:  # noqa: BLE001 — window crash containment
                    logger.exception("Exception preparing window %s:%s-%s",
                                     chrom, window.start_pos, window.end_pos)
                    prepared[w_idx] = "skip"

        # Phase 2 (device): dispatch every window's alignments in a few big
        # batched calls; results are awaited in begin_region_inference.
        live = [(w_idx, p) for w_idx, p in prepared.items()
                if p not in (None, "skip")]
        with metrics.timer("window_prepare"), metrics.timer("pair_fill"):
            fill_deferred_pairs([p.request for _, p in live])
        metrics.count("windows", len(windows))
        metrics.count("beam_windows", 0)  # reads 0, not absent, without one
        metrics.count("alignment_pairs",
                      sum(p.request.n_pairs() for _, p in live
                          if p.request is not None))
        if config.mesh_devices:
            pending = None
        else:
            with metrics.timer("device_dispatch"), device_stage(
                    device, f"alignment dispatch of {chrom}:{start}-{end}"):
                pending = dispatch_alignment_requests(
                    [p.request for _, p in live], device)

        return PreparedRegion(chrom=chrom, start=start, end=end,
                              buffers=buffers, windows=windows,
                              prepared=prepared, live=live, pending=pending)


def device_inference_enabled(config: PlatypusConfig, device) -> bool:
    """--deviceInference: 0 = host float64 path, 1 = fused device path,
    -1 (auto) = on when the run's device is CUDA.  Never on the host path
    (device None), which may use the device-owner service instead."""
    if device is None:
        return False
    if config.device_inference == -1:
        return device.type == "cuda"
    return bool(config.device_inference)


def begin_region_inference(state, config: PlatypusConfig, device) -> None:
    """Await the region's alignment scores and queue the fused
    GL/EM/posterior programs without waiting for them; with
    --meshDevices, queue the mesh's region step instead (its fetch is left
    in state.mesh_fetch for finish_region_call) and align the pair-less
    windows it leaves over.  On the host path, submit the region's
    inference to the device-owner service when the pool runs one.
    Idempotent; finish_region_call calls it if the runner has not."""
    if state.loglik_by_idx is not None or state.mesh_fetch is not None:
        return
    where = f"{state.chrom}:{state.start}-{state.end}"
    with metrics.timer("region_begin", region=where):
        if state.pending is None:
            from ..parallel.mesh import get_engine_mesh, mesh_call_region

            with metrics.timer("device_alignment"), device_stage(
                    device, f"mesh region step of {where}"):
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
                device, f"alignment of {where}"):
            logliks = state.pending.finalize()
        state.loglik_by_idx = {w_idx: ll
                               for (w_idx, _p), ll in zip(state.live, logliks)}
        state.inference_by_idx = {}
        if device_inference_enabled(config, device):
            with metrics.timer("device_inference"), device_stage(
                    device, f"inference dispatch of {where}"):
                state.pending_inference = dispatch_device_inference(
                    state.live, state.loglik_by_idx, len(state.buffers), device)
        elif device is None and config.device_inference != 0:
            # A host worker of a pool that runs the device-owner service:
            # non-blocking submit here; the response hides behind the next
            # region's host work.
            client = get_inference_client()
            if client is not None and client.available():
                try:
                    with metrics.timer("device_inference"):
                        state.pending_inference = dispatch_service_inference(
                            state.live, state.loglik_by_idx, len(state.buffers),
                            client)
                except Exception:  # noqa: BLE001 — fall back to the host path
                    logger.exception("service inference failed; using host path")
                    state.pending_inference = None


def _gather_inference(state, device) -> dict:
    """The region's fused inference results by window index.  A device
    failure raises DeviceError; on the host path a failed service request
    leaves the region to the float64 host path ({})."""
    where = f"{state.chrom}:{state.start}-{state.end}"
    try:
        with metrics.timer("device_inference"), device_stage(
                device, f"inference of {where}"):
            return state.pending_inference.gather()
    except DeviceError:
        raise
    except Exception:  # noqa: BLE001 — host path: service request failed
        logger.exception("service inference failed; using host path")
        return {}
    finally:
        state.pending_inference = None


def finish_region_call(state, ref_file, config: PlatypusConfig, writer,
                       device) -> int:
    """Await the region's device results, then run per-window inference +
    output (in window order).  Returns the number of VCF lines written.
    The state keeps only its coordinates afterwards: freeing the region's
    objects is timed as region_release."""
    chrom, start, end = state.chrom, state.start, state.end
    with metrics.timer("region_finish", region=f"{chrom}:{start}-{end}"):
        n_written = _finish_region(state, ref_file, config, writer, device)
        with metrics.timer("region_release"):
            state.release()
    if config.verbosity >= 3 or os.environ.get("PLATYPUS_TPU_METRICS"):
        metrics.log_summary(f"region {chrom}:{start}-{end} cumulative: ")
    return n_written


def _finish_region(state, ref_file, config: PlatypusConfig, writer,
                   device) -> int:
    """finish_region_call's body, inside its `region_finish` span."""
    chrom, start, end = state.chrom, state.start, state.end
    buffers, windows, prepared = state.buffers, state.windows, state.prepared
    _cache_reference(ref_file, chrom, start - 2000, end + 2000)

    begin_region_inference(state, config, device)
    if state.mesh_fetch is not None:
        fetch_fn, extra = state.mesh_fetch
        with metrics.timer("device_alignment"), device_stage(
                device, f"mesh fetch of {chrom}:{start}-{end}"):
            state.loglik_by_idx, state.inference_by_idx = fetch_fn()
        state.loglik_by_idx.update(extra)
        state.mesh_fetch = None
    if state.pending_inference is not None:
        state.inference_by_idx = _gather_inference(state, device)
    loglik_by_idx = state.loglik_by_idx
    inference_by_idx = state.inference_by_idx or {}

    # Phase 3 (host): per-window inference + output, in window order.
    # The GL/GOF/rescale block of every window computes in one batched
    # pre-pass (bit-identical to the per-window path).
    try:
        with metrics.timer("window_finish"), metrics.timer("gl_prepass"):
            # EM precompute only when the region will take the host EM
            # path; device-inference regions would waste the work (their
            # rare f64-guard-tripped windows recompute per window).
            want_em = not inference_by_idx
            gl_pre = precompute_window_gl(
                [(w_idx, prep, loglik_by_idx[w_idx])
                 for w_idx, prep in ((i, prepared.get(i))
                                     for i, w in enumerate(windows) if w.variants)
                 if prep is not None and prep != "skip"],
                want_em=want_em)
    except Exception:  # noqa: BLE001 — fall back to per-window computation
        logger.exception("batched GL pre-pass failed; using per-window path")
        gl_pre = {}
    n_written = 0
    # REFCALL NR replicates the reference's stale window pointers: the
    # count of each buffer's most recently PROCESSED variant window
    # (variantcaller.pyx:856-866; verified against the running reference),
    # which only REFCALL lines read.
    last_window_nr = [0] * len(buffers)
    for w_idx, window in enumerate(windows):
        try:
            prep = prepared.get(w_idx)
            if prep == "skip":
                continue
            result = None
            if window.variants:
                if prep is not None:
                    if config.output_ref_calls:
                        with metrics.timer("ref_calls"):
                            for _i, _buf in enumerate(buffers):
                                _sl = _buf.window_slice(window.start_pos,
                                                        window.end_pos)
                                last_window_nr[_i] = _sl.stop - _sl.start
                    with metrics.timer("window_finish"), \
                            metrics.timer("window_call"):
                        result = finish_window(
                            prep, loglik_by_idx[w_idx], ref_file, config,
                            inference=inference_by_idx.get(w_idx),
                            precomputed=gl_pre.get(w_idx))
                if result is not None and result.variant_posteriors:
                    with metrics.timer("vcf_output"):
                        n_written += output_call_to_vcf(result, buffers, ref_file, config, writer)
                    if config.output_ref_calls and len(result.vars_by_pos) > 1:
                        with metrics.timer("ref_calls"):
                            n_written += _ref_calls_between_sites(
                                result, chrom, buffers, ref_file, config,
                                writer, last_window_nr)
                elif config.output_ref_calls:
                    with metrics.timer("ref_calls"):
                        output_ref_call(window, buffers, ref_file, config,
                                        writer, call=result,
                                        last_window_nr=last_window_nr)
                    n_written += 1
            elif config.output_ref_calls:
                with metrics.timer("ref_calls"):
                    output_ref_call(window, buffers, ref_file, config, writer,
                                    last_window_nr=last_window_nr)
                n_written += 1
        except Exception as exc:  # noqa: BLE001 — window-level crash containment
            logger.exception(
                "Exception in window %s:%s-%s: %s", chrom, window.start_pos, window.end_pos, exc
            )
    with metrics.timer("vcf_drain"):
        writer.drain()  # flush the 100-line look-ahead before region handoff
    return n_written


def _ref_calls_between_sites(result, chrom, buffers, ref_file, config, writer,
                             last_window_nr) -> int:
    """REFCALL blocks between called positions inside a window
    (variantcaller.pyx:585-607); returns the lines written.

    The reference pairs ADJACENT ITERATION entries of
    varsByPos.iteritems() (variantcaller.pyx:589-602) — insertion order
    under the running py3-harness reference (haplotype-major variant
    enumeration), NOT positional order.  Real-read S55 runs hit the
    difference: blocks span across a middle position whose key was
    inserted later."""
    n_written = 0
    positions = list(result.vars_by_pos.keys())
    for last_pos, next_pos in zip(positions, positions[1:]):
        last_var_end = max(v.max_ref_pos for v in result.vars_by_pos[last_pos])
        next_var_start = min(
            v.min_ref_pos for v in result.vars_by_pos[next_pos]) + 1
        if next_var_start - last_var_end <= 1:
            continue
        for bs in range(last_var_end + 1, next_var_start,
                        config.ref_call_block_size):
            be = min(bs + config.ref_call_block_size, next_var_start - 1)
            if bs == be:
                continue
            output_ref_call(Window(chrom, bs, be, []), buffers, ref_file,
                            config, writer, last_window_nr=last_window_nr)
            n_written += 1
    return n_written


def _cache_reference(ref_file, chrom: str, lo: int, hi: int) -> None:
    """The reference's region cache, inside a `ref_cache` span."""
    with metrics.timer("ref_cache"):
        ref_file.set_cache_sequence(chrom, lo, hi)
