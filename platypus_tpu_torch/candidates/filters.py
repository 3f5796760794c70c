"""Candidate merging/filtering and per-window variant capping.

Mirrors Platypus src/cython/variantFilter.pyx:98-171 (filterVariants:
merge equal sorted candidates accumulating support, drop under-supported
small/large Platypus-only variants and oversize variants) and :571-622
(filterVariantsByCoverage: top-maxVariants by support with assembler
variants prioritised), plus computeVariantReadSupportFrac (:359-373).
"""

from __future__ import annotations

from typing import List, Optional

from .variant import ASSEMBLER_VAR, FILE_VAR, PLATYPUS_VAR, Variant


def filter_variants(var_list: List[Variant], min_support: int, min_reads: int,
                    max_size: int) -> List[Variant]:
    filtered: List[Variant] = []
    last: Optional[Variant] = None

    def passes(v: Variant, final: bool) -> bool:
        support = v.n_supporting_reads
        source = v.var_source
        platypus_only = (
            bool(source & PLATYPUS_VAR)
            and not (source & ASSEMBLER_VAR)
            and not (source & FILE_VAR)
        )
        if final:
            # Tail variant check uses only the small-variant rule
            # (variantFilter.pyx:157-169).
            return not (support < min_support and platypus_only)
        var_size = max(v.n_added, v.n_removed)
        if support < min_support and var_size < 15 and platypus_only:
            return False
        if support < min_reads and var_size >= 15 and platypus_only:
            return False
        if var_size > max_size:
            return False
        return True

    for v in var_list:
        if last is None:
            last = v
        elif v == last:
            last.add_variant(v)
        else:
            if passes(last, final=False):
                filtered.append(last)
            last = v
    if last is not None and passes(last, final=True):
        filtered.append(last)
    return sorted(filtered)


def compute_variant_read_support_frac(variant: Variant, buffer) -> float:
    """Fraction of reads at the variant position supporting it
    (variantFilter.pyx:359-373)."""
    n_total = buffer.count_reads_covering_region(variant.ref_pos, variant.ref_pos + 1)
    if n_total == 0:
        return 0.0
    return variant.n_supporting_reads / n_total


def filter_variants_by_coverage(variants: List[Variant], max_variants: int) -> List[Variant]:
    """Top-maxVariants by support, assembler variants first
    (variantFilter.pyx:571-622)."""
    if not variants:
        return variants
    max_support = max(v.n_supporting_reads for v in variants)
    ranked = []
    for v in variants:
        if v.var_source == ASSEMBLER_VAR:
            ranked.append((max_support + 1, v))
        else:
            ranked.append((v.n_supporting_reads, v))
    ranked.sort(key=lambda t: (t[0], t[1].sort_key()), reverse=True)
    return sorted(t[1] for t in ranked[:max_variants])
