"""Per-window preparation whose scoring reaches the device, torch.

Twins of platypus_tpu/engine/caller.py's prepare_window,
get_haplotypes_in_window, _beam_search_haplotypes and call_window: the
only caller functions that score reads on a device (the beam search ranks
candidate haplotypes by aligning subsampled reads; call_window aligns one
window, for the HLA path).  Here they score through the port's scorer on
an explicit device.  Everything else -- haplotype enumeration and
merging, finish_window with its f64-exactness guard -- is the JAX
package's host code.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from platypus_tpu.candidates.filters import filter_variants_by_coverage
from platypus_tpu.candidates.normalize import is_haplotype_valid
from platypus_tpu.candidates.variant import Variant
from platypus_tpu.candidates.windows import Window
from platypus_tpu.config import PlatypusConfig, RuntimeState
from platypus_tpu.engine.caller import (PreparedWindow, WindowCall,
                                        _all_subset_haplotypes,
                                        _subsample_read_rows, _subset_reads,
                                        finish_window)
from platypus_tpu.engine.score import (WindowReads, build_alignment_request,
                                       gather_window_reads)
from platypus_tpu.io.readbuffer import SampleReadBuffer
from platypus_tpu.models.haplotype import Haplotype, merge_haplotypes

from .score import run_alignment_requests, score_reads_vs_haplotypes


def _beam_search_haplotypes(
    window: Window,
    variants: List[Variant],
    ref_hap: Haplotype,
    buffers: Sequence[SampleReadBuffer],
    reads: WindowReads,
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device: torch.device,
) -> List[Haplotype]:
    """Support-ordered greedy haplotype growth (variantFilter.pyx:440-506),
    scoring each growth round's candidates in one device call."""
    original_max = rt.original_max_haplotypes - 1
    max_haps = rt.max_haplotypes - 1
    window_size = window.end_pos - window.start_pos
    sample_rows = _subsample_read_rows(reads, window_size,
                                       config.coverage_sampling_level, len(buffers))

    sub = _subset_reads(reads, sample_rows)
    sample_masks = [sub.sample_idx == i for i in range(len(buffers))]
    sample_masks = [m for m in sample_masks if m.any()]

    def genotype_best_scores(haps: List[Haplotype]) -> np.ndarray:
        """Per candidate hap: max over samples of
        sum_r ln(0.5 e^s_ref + 0.5 e^s_hap) over the subsampled rows
        (computeBestScoreForGenotype, variantFilter.pyx:237-283)."""
        ll = score_reads_vs_haplotypes([ref_hap] + haps, sub, device,
                                       use_map_qual_cap=False)
        with np.errstate(over="ignore"):
            per_read = np.log(0.5 * (np.exp(ll[:1]) + np.exp(ll[1:])))  # [C, R]
        if not sample_masks:
            return np.full(len(haps), -1e20)
        return np.max(
            np.stack([per_read[:, m].sum(axis=1) for m in sample_masks]), axis=0
        )

    vars_by_cov = sorted(variants, key=lambda v: v.n_supporting_reads, reverse=True)
    heap: List[Tuple[float, Tuple[Variant, ...]]] = []

    for temp_var in vars_by_cov:
        old = sorted(heap)
        var_tuple = (temp_var,)
        candidates = [var_tuple]
        for _score, _sk, vars2 in old:
            combo = tuple(sorted(var_tuple + vars2, key=lambda v: v.sort_key()))
            if is_haplotype_valid(combo):
                candidates.append(combo)
        cand_haps = [
            Haplotype(window.chromosome, window.start_pos, window.end_pos,
                      combo, ref_file, rt.rlen)
            for combo in candidates
        ]
        scores = genotype_best_scores(cand_haps)
        for combo, score in zip(candidates, scores):
            key = (float(score), tuple(v.sort_key() for v in combo), combo)
            if len(heap) < original_max:
                heapq.heappush(heap, key)
            else:
                heapq.heappushpop(heap, key)

    out = []
    for index, (_score, _sk, combo) in enumerate(sorted(heap, reverse=True)):
        if index >= max_haps:
            break
        out.append(Haplotype(window.chromosome, window.start_pos, window.end_pos,
                             combo, ref_file, rt.rlen))
    return out


def get_haplotypes_in_window(
    window: Window,
    variants: List[Variant],
    ref_hap: Haplotype,
    buffers: Sequence[SampleReadBuffer],
    reads: WindowReads,
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device: torch.device,
) -> List[Haplotype]:
    max_haps = rt.max_haplotypes - 1
    n_vars = len(variants)
    if n_vars <= math.log2(max_haps) or (
        config.filter_vars_by_coverage and config.max_variants <= math.log2(max_haps)
    ):
        return _all_subset_haplotypes(window, variants, ref_file, rt.rlen)
    return _beam_search_haplotypes(window, variants, ref_hap, buffers, reads,
                                   ref_file, config, rt, device)


def prepare_window(
    window: Window,
    buffers: Sequence[SampleReadBuffer],
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device: torch.device,
    region_reads=None,
    defer_pairs: bool = False,
) -> Optional[PreparedWindow]:
    """Everything before the batched alignment pass: read gathering,
    haplotype enumeration/merging, pair construction.  Returns None for
    skipped windows (callVariantsInWindow gating, variantcaller.pyx:74-137)."""
    chrom = window.chromosome
    variants = list(window.variants)

    ref_hap = Haplotype(chrom, window.start_pos, window.end_pos, (), ref_file, rt.rlen)

    n_reads_window = 0
    for b in buffers:
        sl = b.window_slice(window.start_pos, window.end_pos)
        n_reads_window += sl.stop - sl.start
    if n_reads_window == 0 and not config.output_ref_calls:
        return None
    if n_reads_window > config.max_reads:
        return None

    if len(variants) > config.max_variants:
        if config.skip_difficult_windows:
            return None
        if config.filter_vars_by_coverage:
            variants = filter_variants_by_coverage(variants, config.max_variants)
            window.variants = variants

    if region_reads is not None:
        reads = region_reads.gather(window.start_pos, window.end_pos)
    else:
        reads = gather_window_reads(buffers, window.start_pos, window.end_pos)

    if n_reads_window == 0:
        var_haps: List[Haplotype] = []
    else:
        var_haps = get_haplotypes_in_window(
            window, variants, ref_hap, buffers, reads, ref_file, config, rt,
            device)
    all_haps = merge_haplotypes([ref_hap] + var_haps, ref_file)
    if len(all_haps) <= 1 and not config.output_ref_calls:
        return None
    ref_idx = next(i for i, h in enumerate(all_haps) if h == ref_hap)
    request = build_alignment_request(
        all_haps, reads, use_map_qual_cap=bool(config.hla_typing),
        calculate_flank_score=bool(config.calculate_flank_score),
        defer_pairs=defer_pairs,
    )
    return PreparedWindow(window, buffers, all_haps, ref_idx, reads, request)


def call_window(
    window: Window,
    buffers: Sequence[SampleReadBuffer],
    ref_file,
    config: PlatypusConfig,
    rt: RuntimeState,
    device: torch.device,
) -> Optional[WindowCall]:
    """Single-window convenience wrapper (caller.py:672-686): prepare ->
    align on `device` -> the JAX package's finish_window.  A failure of
    the device work raises DeviceError."""
    prep = prepare_window(window, buffers, ref_file, config, rt, device)
    if prep is None:
        return None
    loglik = run_alignment_requests([prep.request], device)[0]
    return finish_window(prep, loglik, ref_file, config)
