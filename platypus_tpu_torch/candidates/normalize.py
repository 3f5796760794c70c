"""Variant normalisation and haplotype-validity rules.

* left_normalise_indel: shift pure indels left against the reference by
  rebuilding the local haplotype (platypusutils.pyx:806-931), keeping the
  BAM-reported span for read-support counting;
* is_haplotype_valid: which sorted variant combinations can coexist on one
  haplotype (platypusutils.pyx:735-802);
* normalise_var / trim_long_var: leading/trailing base trimming for long
  replacement alleles (variantFilter.pyx:747-802, HLA path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .variant import Variant


def left_normalise_indel(variant: Variant, ref_file, max_read_length: int) -> Variant:
    n_added = variant.n_added
    n_removed = variant.n_removed
    if n_added == n_removed or (n_added > 0 and n_removed > 0):
        return variant
    if variant.ref_pos < 100:
        return variant

    window = max(n_added, n_removed) + max_read_length
    seq_max = ref_file.refs[variant.ref_name].length - 1
    window_min = max(1, variant.ref_pos - window)
    window_max = min(variant.ref_pos + window, seq_max)

    ref_seq = ref_file.get_sequence(variant.ref_name, window_min, window_max)
    hap_seq = (
        ref_seq[: (variant.ref_pos - window_min) + 1]
        + variant.added
        + ref_seq[(variant.ref_pos - window_min + n_removed) + 1 :]
    )

    len_ref = len(ref_seq)
    len_hap = len(hap_seq)
    min_len = min(len_ref, len_hap)

    # How far right the indel can shift (gives bamMaxPos).
    fwd = 0
    for fwd in range(min_len):
        if hap_seq[fwd] != ref_seq[fwd]:
            break
    max_pos = window_min + fwd + n_removed

    for index in range(min_len):
        hap_i = len_hap - index - 1
        ref_i = len_ref - index - 1
        if hap_seq[hap_i] != ref_seq[ref_i]:
            new_pos = window_min + len_ref - index - n_removed - 1
            new_added = b""
            new_removed = b""
            if n_added > 0:
                ins_start = new_pos - window_min + 1
                new_added = hap_seq[ins_start : ins_start + n_added]
            if n_removed > 0:
                del_start = new_pos - window_min + 1
                new_removed = ref_seq[del_start : del_start + n_removed]
            if len(new_added) != n_added or len(new_removed) != n_removed:
                # Ran off the window edge; keep the BAM position.
                return variant
            new_var = Variant(
                variant.ref_name, new_pos, new_removed, new_added,
                variant.n_supporting_reads, variant.var_source,
            )
            new_var.bam_min_pos = new_pos
            new_var.bam_max_pos = max_pos
            new_var.bam_added = variant.bam_added
            new_var.bam_removed = variant.bam_removed
            return new_var

    return variant


def is_haplotype_valid(variants: Sequence[Variant]) -> bool:
    n = len(variants)
    if n <= 1:
        return True
    for index in range(n - 1):
        this_var = variants[index]
        next_var = variants[index + 1]
        if this_var.min_ref_pos > next_var.min_ref_pos:
            raise ValueError("variants out of order in haplotype")
        if this_var.max_ref_pos > next_var.min_ref_pos:
            return False
        if this_var.max_ref_pos == next_var.min_ref_pos:
            # A SNP/MNP may abut a following indel (which acts after its
            # anchor base); everything else collides.
            if this_var.n_added == this_var.n_removed and next_var.n_added < next_var.n_removed:
                continue
            if this_var.n_added == this_var.n_removed and next_var.n_added > next_var.n_removed:
                continue
            return False
    return True


def normalise_var(var: Variant) -> Variant:
    """Trim shared leading/trailing bases from replacement alleles
    (variantFilter.pyx:747-768)."""
    if var.n_removed == 1:
        return var
    added = var.added
    removed = var.removed
    ref_pos = var.ref_pos
    while added and removed and removed[0] == added[0]:
        added = added[1:]
        removed = removed[1:]
        ref_pos += 1
    while added and removed and removed[-1] == added[-1]:
        added = added[:-1]
        removed = removed[:-1]
    return Variant(var.ref_name, ref_pos, removed, added,
                   var.n_supporting_reads, var.var_source)


def trim_long_var(var: Variant, window_start: int, window_end: int) -> Variant:
    """Clip a long replacement to the window, then trim shared context
    (variantFilter.pyx:770-802)."""
    if var.n_removed == 1:
        return var
    added = var.added
    removed = var.removed
    ref_pos = var.ref_pos
    if len(added) == len(removed):
        if ref_pos + len(removed) > window_end:
            diff = ref_pos + len(removed) - window_end
            added = added[: len(added) - diff]
            removed = removed[: len(removed) - diff]
        if ref_pos < window_start:
            diff = window_start - ref_pos
            # NB: the reference advances the allele pointers but not refPos
            # here (variantFilter.pyx:788-791); kept for output parity.
            added = added[diff:]
            removed = removed[diff:]
    while added and removed and removed[0] == added[0]:
        added = added[1:]
        removed = removed[1:]
        ref_pos += 1
    while added and removed and removed[-1] == added[-1]:
        added = added[:-1]
        removed = removed[:-1]
    return Variant(var.ref_name, ref_pos, removed, added,
                   var.n_supporting_reads, var.var_source)
