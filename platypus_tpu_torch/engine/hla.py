"""HLA typing mode: region-length haplotype genotyping.

Reimplements the reference's HLA path (variantcaller.pyx:146-206,619-738;
variantFilter.pyx:654-744,804-901; vcfutils.pyx:602-792):

* assembly-derived candidates are called per window with the standard model
  and the winning haplotypes re-expressed as whole-window replacement
  variants;
* candidate region haplotypes come from the source VCF (one haplotype per
  FILE variant) and from all valid combinations of the assembler's long
  variants, ranked by read likelihood (capped at HLA_MAX_HAPLOTYPES) when
  too many;
* the final call scores ALL ordered haplotype pairs per sample with
  map-quality-capped likelihoods, reporting GT:GL:NR:NV1:NV2 plus a
  confidence score from the top-two likelihood gap.

Every scoring step runs on `device` (a torch device, or None for the host
path).  A window whose call fails on the host is skipped and logged, but a
DeviceError (any failure of the device work) propagates and stops the run.
"""

from __future__ import annotations

import heapq
import logging
from itertools import combinations
from typing import List, Sequence, Tuple

import numpy as np

from ..candidates.normalize import (is_haplotype_valid, normalise_var,
                                    trim_long_var)
from ..candidates.variant import ASSEMBLER_VAR, FILE_VAR, Variant
from ..candidates.windows import Window, generate_windows
from ..config import PlatypusConfig, RuntimeState
from ..io.vcfsource import VariantCandidateReader
from ..models.haplotype import Haplotype, merge_haplotypes
from ..ops.likelihood import LOG_HALF
from ..utils.backend import DeviceError
from .caller import call_window
from .region import generate_variants_in_region, load_region_buffers
from .score import gather_window_reads, score_reads_vs_haplotypes

logger = logging.getLogger("platypus_tpu")

# Cap on the ranked region haplotypes (the reference's 150).
HLA_MAX_HAPLOTYPES = 150


def _rank_haplotypes_two_rounds(
    haps: List[Haplotype], reads, n_individuals: int, original_max: int,
    per_round_out: int, window_size: int, target_coverage: int,
    device,
) -> List[Haplotype]:
    """The reference's two-round region ranking (hla.py:38-112): round 1
    ranks each haplotype alone by its summed read log-likelihoods, round 2
    each haplotype paired with round 1's best over subsampled reads, both
    into one heap capped at original_max; each round emits its top
    per_round_out."""
    loglik = score_reads_vs_haplotypes(haps, reads, device,
                                       use_map_qual_cap=False)
    sample_rows = [
        np.nonzero((reads.sample_idx == i) & reads.is_good)[0]
        for i in range(n_individuals)
    ]

    heap: List[Tuple[float, Haplotype]] = []

    def push(item):
        if len(heap) < original_max:
            heapq.heappush(heap, item)
        else:
            heapq.heappushpop(heap, item)

    for idx, hap in enumerate(haps):
        best = -1e20
        for rows in sample_rows:
            s = 0.0
            for r in rows:
                s += float(loglik[idx, r])
            best = max(best, s)
        push((best, hap))

    out: List[Haplotype] = []
    for rank, (_s, hap) in enumerate(sorted(heap, reverse=True)):
        if rank < per_round_out:
            out.append(hap)
        else:
            break

    best_hap = sorted(heap, reverse=True)[0][1]
    best_idx = next(i for i, h in enumerate(haps) if h is best_hap)

    log, exp = np.log, np.exp
    for idx, hap in enumerate(haps):
        best = -1e20
        for rows in sample_rows:
            if len(rows) == 0:
                continue
            mean_cov = int(reads.rlen[rows[0]]) * len(rows) // window_size
            rate = max(1, mean_cov // target_coverage)
            s = 0.0
            for r in rows[::rate]:
                s += float(log(0.5 * (exp(loglik[best_idx, r])
                                      + exp(loglik[idx, r]))))
            best = max(best, s)
        push((best, hap))

    for rank, (_s, hap) in enumerate(sorted(heap, reverse=True)):
        if rank < per_round_out:
            out.append(hap)
        else:
            break
    return out


def get_all_hla_haplotypes_in_region(
    chrom: str, start: int, end: int, ref_file, config: PlatypusConfig,
    rt: RuntimeState, variants: Sequence[Variant], reads, n_individuals: int,
    device,
) -> List[Haplotype]:
    """One haplotype per FILE variant; rank if > 150 (hla.py:115-131)."""
    haps = [
        Haplotype(chrom, start, end, (v,), ref_file, rt.rlen)
        for v in variants
        if v.var_source == FILE_VAR
    ]
    if len(haps) <= HLA_MAX_HAPLOTYPES:
        return haps
    return _rank_haplotypes_two_rounds(
        haps, reads, n_individuals, rt.original_max_haplotypes - 1,
        HLA_MAX_HAPLOTYPES // 2, end - start, config.coverage_sampling_level,
        device,
    )


def get_all_assembler_haplotypes_in_region(
    chrom: str, start: int, end: int, ref_file, config: PlatypusConfig,
    rt: RuntimeState, variants: Sequence[Variant], reads, n_individuals: int,
    device,
) -> List[Haplotype]:
    """All valid combinations of trimmed assembler long variants, ranked
    when too many (hla.py:134-159)."""
    assembler_vars = [
        trim_long_var(v, start, end) for v in variants if v.var_source == ASSEMBLER_VAR
    ]
    haps: List[Haplotype] = []
    for n in range(1, len(assembler_vars) + 1):
        if len(haps) > 4 * HLA_MAX_HAPLOTYPES:
            break
        for combo in combinations(assembler_vars, n):
            combo = tuple(sorted(combo, key=lambda v: v.sort_key()))
            if is_haplotype_valid(combo):
                haps.append(Haplotype(chrom, start, end, combo, ref_file, rt.rlen))
    if len(haps) <= rt.max_haplotypes - 1:
        return haps
    return _rank_haplotypes_two_rounds(
        haps, reads, n_individuals, rt.original_max_haplotypes - 1,
        (rt.max_haplotypes - 1) // 2, end - start,
        config.coverage_sampling_level, device,
    )


def call_hla_window_long_vars(window: Window, buffers, ref_file,
                              config: PlatypusConfig, rt: RuntimeState,
                              device) -> List[Variant]:
    """Standard window call on `device`, then the winning haplotypes as
    whole-window replacement variants (hla.py:162-180)."""
    result = call_window(window, buffers, ref_file, config, rt, device)
    if result is None:
        return []
    gt_idx = result.genotype_calls[0]
    if gt_idx is None:
        return []
    h1 = result.haplotypes[result.hap1_idx[gt_idx]]
    h2 = result.haplotypes[result.hap2_idx[gt_idx]]
    ref_hap = result.haplotypes[result.ref_hap_index]
    out = []
    if h1 != ref_hap:
        out.append(normalise_var(h1.long_var))
    if h2 != ref_hap and h1 != h2:
        out.append(normalise_var(h2.long_var))
    return out


def output_hla_call_to_vcf(haplotypes: List[Haplotype], buffers, ref_file,
                           config: PlatypusConfig, out, window_start: int,
                           window_end: int, device) -> None:
    """All-ordered-pairs genotyping + one VCF line (hla.py:183-322), with
    map-quality-capped likelihoods scored on `device`."""
    n_ind = len(buffers)
    chrom = haplotypes[0].long_var.ref_name
    reads = gather_window_reads(buffers, window_start, window_end)
    H = len(haplotypes)
    loglik = score_reads_vs_haplotypes(haplotypes, reads, device,
                                       use_map_qual_cap=True)

    alts: List[str] = []
    ref_seq = ""
    var_source = set()
    all_gts, gls, nrs, nv1s, nv2s, cfs = [], [], [], [], [], []

    score_file = open(config.align_score_file, "a") if config.align_score_file else None

    for i in range(n_ind):
        good_rows = np.nonzero((reads.sample_idx == i) & reads.is_good)[0]
        all_rows = np.nonzero(reads.sample_idx == i)[0]
        n_reads = len(good_rows)
        nrs.append(n_reads)
        if n_reads == 0:
            all_gts.append([])
            gls.append(0.0)
            nv1s.append([])
            nv2s.append([])
            cfs.append(0.0)
            continue

        ll = loglik[:, all_rows]  # [H, R_i]
        # Genotype likelihood for every ordered pair (hap1, hap2).
        l1 = ll[:, None, :]
        l2 = ll[None, :, :]
        diff = np.abs(l1 - l2)
        mx = np.maximum(l1, l2)
        with np.errstate(over="ignore"):
            exact = np.log(0.5 * (np.exp(l1) + np.exp(l2)))
        same = np.eye(H, dtype=bool)[:, :, None]
        per_read = np.where(
            same, l1,
            np.where(diff >= 3.0, LOG_HALF + mx, np.where(diff <= 1e-3, l1, exact)),
        )
        pair_ll = per_read.sum(axis=2)  # [H, H]

        if score_file is not None:
            # --alignScoreFile dump (vcfutils.pyx:666-716): per-individual
            # haplotype sequences and the ordered-pair likelihood matrix.
            score_file.write(f"Individual\t{i}\t{H}\t{n_reads}:{window_start}-{window_end}\n")
            for hap in haplotypes:
                score_file.write(
                    f"{hap.start_pos + 1} {hap.end_pos} "
                    f"{hap.short_haplotype_sequence.decode()}\n"
                )
            for h1 in range(H):
                score_file.write("\t".join(str(pair_ll[h1, h2]) for h2 in range(H)) + "\n")

        best_genotypes: List[List[int]] = []
        max_like = 0.0
        second_candidates: List[float] = []
        for h1 in range(H):
            for h2 in range(H):
                v = float(pair_ll[h1, h2])
                pair = sorted([h1, h2])
                if not best_genotypes or v > max_like:
                    max_like = v
                    best_genotypes = [pair]
                    second_candidates.append(v)
                elif v == max_like and pair not in best_genotypes:
                    best_genotypes.append(pair)
        if len(second_candidates) > 1:
            second_max = sorted(second_candidates, reverse=True)[1]
        else:
            second_max = max_like - 100.0

        this_gts: List[str] = []
        this_nv1: List[int] = []
        this_nv2: List[int] = []
        for rank, (i1, i2) in enumerate(best_genotypes):
            hap1, hap2 = haplotypes[i1], haplotypes[i2]
            alt1 = hap1.short_haplotype_sequence.decode()
            alt2 = hap2.short_haplotype_sequence.decode()
            var_source.add(hap1.long_var.var_source)
            var_source.add(hap2.long_var.var_source)
            if rank == 0 and not ref_seq:
                ref_seq = hap1.short_reference_sequence.decode()
            if alt1 != ref_seq and alt1 not in alts:
                alts.append(alt1)
            if alt2 != ref_seq and alt2 not in alts:
                alts.append(alt2)
            alt_idx1 = alts.index(alt1) + 1 if alt1 in alts else 0
            alt_idx2 = alts.index(alt2) + 1 if alt2 in alts else 0
            this_gts.append(f"{alt_idx1}/{alt_idx2}")
            # NV: reads with per-read phred penalty < 5 against each hap.
            gscores = -10.0 * loglik[:, good_rows]
            this_nv1.append(int((gscores[i1] < 5).sum()))
            this_nv2.append(int((gscores[i2] < 5).sum()))

        if max_like != 0.0:
            confidence = -(max_like - second_max) * (window_end - window_start) / max_like
        elif H > 1:
            confidence = max_like - second_max
        else:
            confidence = 100.0

        all_gts.append(this_gts)
        gls.append(max_like)
        nv1s.append(this_nv1)
        nv2s.append(this_nv2)
        cfs.append(confidence)

    if score_file is not None:
        score_file.close()

    qual = max(int(cf) for cf in cfs) if cfs else 0
    if not alts:
        alts_out = ["."]
        line_filter = "REFCALL"
    else:
        alts_out = alts
        line_filter = "PASS"
    if not ref_seq:
        ref_seq = ref_file.get_sequence(chrom, window_start, window_end).decode()

    info = (
        f"WS={window_start + 1};WE={window_end};Size={window_end - window_start + 1}"
        f";varSource={','.join(map(str, sorted(var_source)))}"
    )
    line = "\t".join([
        chrom, str(window_start + 1), ".", ref_seq, ",".join(alts_out),
        str(qual), line_filter, info, "GT:GL:NR:NV1:NV2",
    ])
    for i in range(n_ind):
        line += "\t" + ":".join([
            ",".join(all_gts[i]), str(gls[i]), str(nrs[i]),
            ",".join(map(str, nv1s[i])), ",".join(map(str, nv2s[i])),
        ])
    out.write(line + "\n")


def call_hla_variants_in_region(
    chrom: str, start: int, end: int, bam_files, samples_by_bam, ref_file,
    config: PlatypusConfig, rt: RuntimeState, out, device,
) -> int:
    """One HLA typing region (hla.py:325-419) on `device`."""
    ref_file.set_cache_sequence(chrom, start - 10 * rt.rlen, end + 10 * rt.rlen)
    buffers = load_region_buffers(bam_files, samples_by_bam, chrom, start, end, config)
    if buffers is None:
        return 0

    variant_source: List[Variant] = []
    if config.source_file:
        reader = VariantCandidateReader(config.source_file,
                                        long_haps=bool(config.long_haps))
        variant_source = reader.variants(chrom, start, end)

    # Assembly candidates with the source file masked off.
    saved_source = config.source_file
    config.source_file = None
    try:
        all_assembly = generate_variants_in_region(
            chrom, start - config.assembler_kmer_size, end + config.assembler_kmer_size,
            ref_file, buffers, config, rt,
        )
    finally:
        config.source_file = saved_source

    filtered: List[Variant] = []
    for v in all_assembly:
        if v.ref_pos + v.n_removed < start:
            continue
        if v.ref_pos > end:
            continue
        if v.var_type == 3 and v.n_removed > end - v.ref_pos and v.n_removed > 200:
            continue
        filtered.append(trim_long_var(v, start, end))

    max_contig_pos = ref_file.refs[chrom].length - 1
    long_vars: List[Variant] = []
    n_windows = 0
    for window in generate_windows(
        chrom, start, end, max_contig_pos, filtered, rlen=rt.rlen,
        max_size=config.max_size, large_windows=bool(config.large_windows),
        max_var_dist=config.max_var_dist, min_var_dist=config.min_var_dist,
        max_variants=config.max_variants,
        merge_clustered=bool(config.merge_clustered_variants),
    ):
        n_windows += 1
        try:
            if window.end_pos - window.start_pos > config.max_size and window.variants:
                continue
            if window.variants:
                long_vars.extend(call_hla_window_long_vars(
                    window, buffers, ref_file, config, rt, device))
        except DeviceError:
            raise  # the window's device work is not contained
        except Exception:  # noqa: BLE001 — window crash containment
            logger.exception("HLA window %s:%s-%s skipped", chrom,
                             window.start_pos, window.end_pos)

    ref_hap = Haplotype(chrom, start, end, (), ref_file, rt.rlen)
    reads = gather_window_reads(buffers, start, end)

    source_haps: List[Haplotype] = []
    if variant_source:
        source_haps = get_all_hla_haplotypes_in_region(
            chrom, start, end, ref_file, config, rt, variant_source, reads,
            len(buffers), device,
        )

    if n_windows == 0:
        if end - start < 10:
            ref = ref_file.get_sequence(chrom, start, end).decode()
            info = f"WS={start};WE={end};Size={end - start + 1}"
            line = "\t".join([chrom, str(start + 1), ".", ref, ".", "100",
                              "REFCALL", info, "GT:GL:NR:NV1:NV2"])
            for buf in buffers:
                sl = buf.window_slice(start, end)
                n = sl.stop - sl.start
                line += "\t" + ":".join(["0/0", "0.0", str(n), str(n), str(n)])
            out.write(line + "\n")
            return 1
        all_haps = source_haps
    else:
        assembler_haps = get_all_assembler_haplotypes_in_region(
            chrom, start, end, ref_file, config, rt,
            sorted(long_vars, key=lambda v: v.sort_key()), reads, len(buffers),
            device,
        )
        all_haps = assembler_haps + source_haps

    unique = merge_haplotypes([ref_hap] + all_haps, ref_file)
    output_hla_call_to_vcf(unique, buffers, ref_file, config, out, start, end,
                           device)
    return 1
