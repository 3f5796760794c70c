"""Haplotype model: variant splicing, flank padding, gap-open annotation.

Mirrors Platypus src/cython/chaplotype.pyx:120-590:

* a haplotype is the window's reference sequence with its variant set
  spliced in, padded on both sides by endBufferSize = min(2*maxReadLen, 500)
  bases of reference flank;
* identity/ordering is (refName, startPos, haplotypeSequence) so equal
  sequences merge (mergeHaplotypes keeps the lowest-prior variant set);
* each haplotype carries a per-base homopolymer gap-open array and a 7-mer
  index for the aligner.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..candidates.variant import Variant
from ..ops.kmer import HaplotypeKmerIndex
from .error_model import annotate_gap_open

MAX_HAPLOTYPE_LEN = 4 ** 7  # hash_size cap (chaplotype.pyx:180-183)


def build_mutated_sequence(ref_file, ref_name: str, start: int, end: int,
                           variants: Sequence[Variant]) -> bytes:
    """Splice sorted variants into ref[start, end) (chaplotype.pyx:397-449)."""
    if not variants:
        return ref_file.get_sequence(ref_name, start, end)
    parts: List[bytes] = []
    current = start
    first = variants[0]
    if first.ref_pos != current:
        parts.append(ref_file.get_sequence(ref_name, current, first.ref_pos))
        current = first.ref_pos
    for v in variants:
        if v.ref_pos > current:
            parts.append(ref_file.get_sequence(ref_name, current, v.ref_pos))
            current = v.ref_pos
        if v.n_added == v.n_removed:
            parts.append(v.added)
            current += v.n_removed
        else:
            # Pure indels keep the anchor base when the variant starts here.
            if (v.n_added == 0 or v.n_removed == 0) and v.ref_pos == current:
                parts.append(ref_file.get_character(ref_name, v.ref_pos))
                current += 1
            current += v.n_removed
            parts.append(v.added)
    if current < end:
        parts.append(ref_file.get_sequence(ref_name, current, end))
    return b"".join(parts)


@functools.total_ordering
class Haplotype:
    def __init__(self, ref_name: str, start_pos: int, end_pos: int,
                 variants: Tuple[Variant, ...], ref_file, max_read_length: int):
        self.ref_name = ref_name
        self.ref_file = ref_file
        self.variants = tuple(variants)
        self.start_pos = max(0, start_pos)
        self.end_pos = min(end_pos, ref_file.refs[ref_name].length - 1)
        self.max_read_length = max_read_length
        self.end_buffer_size = min(2 * max_read_length, 500)

        self.short_reference_sequence = ref_file.get_sequence(
            ref_name, self.start_pos, self.end_pos
        )
        if variants:
            self.min_var_pos = min(v.min_ref_pos for v in variants)
            self.max_var_pos = max(v.max_ref_pos for v in variants)
            if self.min_var_pos == self.max_var_pos:
                self.max_var_pos += 1
            self.short_haplotype_sequence = build_mutated_sequence(
                ref_file, ref_name, self.start_pos, self.end_pos, variants
            )
            long_source = variants[0].var_source
        else:
            self.min_var_pos = self.start_pos
            self.max_var_pos = self.end_pos
            self.short_haplotype_sequence = self.short_reference_sequence
            long_source = 1
        # Whole-window single replacement (HLA long-variant representation).
        self.long_var = Variant(
            ref_name, start_pos, self.short_reference_sequence,
            self.short_haplotype_sequence, 0, long_source,
        )

        if not variants:
            self.sequence = ref_file.get_sequence(
                ref_name, self.start_pos - self.end_buffer_size,
                self.end_pos + self.end_buffer_size,
            )
        else:
            left = ref_file.get_sequence(
                ref_name, self.start_pos - self.end_buffer_size, self.start_pos
            )
            right = ref_file.get_sequence(
                ref_name, self.end_pos, self.end_pos + self.end_buffer_size
            )
            self.sequence = left + self.short_haplotype_sequence + right

        self.hap_len = len(self.sequence)
        if self.hap_len > MAX_HAPLOTYPE_LEN:
            raise ValueError(
                f"Haplotype too long ({self.hap_len} > {MAX_HAPLOTYPE_LEN}) "
                f"for window {ref_name}:{start_pos}-{end_pos}"
            )
        # Genomic position the sequence starts at (alignment anchor origin;
        # chaplotype.pyx:606 — NOT clamped at contig start, by design).
        self.hap_start = self.start_pos - self.end_buffer_size

        self._gap_open: Optional[np.ndarray] = None
        self._kmer_index: Optional[HaplotypeKmerIndex] = None
        self._sort_key = (self.ref_name, self.start_pos, self.sequence)

    # -- lazy annotations ---------------------------------------------------
    @property
    def gap_open(self) -> np.ndarray:
        if self._gap_open is None:
            self._gap_open = annotate_gap_open(self.sequence)
        return self._gap_open

    @property
    def kmer_index(self) -> HaplotypeKmerIndex:
        if self._kmer_index is None:
            self._kmer_index = HaplotypeKmerIndex(self.sequence)
        return self._kmer_index

    # -- identity ------------------------------------------------------------
    def __hash__(self):
        return hash(self._sort_key)

    def __eq__(self, other):
        return self._sort_key == other._sort_key

    def __lt__(self, other):
        return self._sort_key < other._sort_key

    def __repr__(self):
        if not self.variants:
            return f"Haplotype(*Reference*) {self.ref_name}:{self.start_pos}-{self.end_pos}"
        vs = ",".join(v.short_repr() for v in self.variants)
        return f"Haplotype({vs}) {self.ref_name}:{self.start_pos}-{self.end_pos}"

    # -- VCF annotation seeds (chaplotype.pyx:451-531) ------------------------
    def homopolymer_length_for_variant(self, variant: Variant) -> int:
        pos = variant.ref_pos
        left = self.ref_file.get_sequence(self.ref_name, pos - 20, pos)
        right = self.ref_file.get_sequence(self.ref_name, pos + 1, pos + 21)
        if not left or not right:
            return 0
        lc, rc = left[-1], right[0]
        lsize = 0
        for ch in reversed(left):
            if ch == lc:
                lsize += 1
            else:
                break
        rsize = 0
        for ch in right:
            if ch == rc:
                rsize += 1
            else:
                break
        return lsize + rsize if lc == rc else max(lsize, rsize)

    def sequence_context(self, variant: Variant) -> bytes:
        pos = variant.ref_pos
        return self.ref_file.get_sequence(self.ref_name, pos - 10, pos + 11)

    def vcf_info_seed(self) -> dict:
        return {
            v: {"HP": [self.homopolymer_length_for_variant(v)],
                "SC": [self.sequence_context(v).decode()]}
            for v in self.variants
        }


def merge_haplotypes(haplotypes: List[Haplotype], ref_file) -> List[Haplotype]:
    """Collapse identical-sequence haplotypes, keeping the variant set with
    the lowest combined prior (variantcaller.pyx:325-390)."""
    merged: List[Haplotype] = []
    last: Optional[Haplotype] = None
    for hap in sorted(haplotypes):
        if last is None:
            last = hap
        elif hap == last:
            prior_last = 1.0
            for v in last.variants:
                prior_last *= v.calculate_prior(ref_file)
            prior_hap = 1.0
            for v in hap.variants:
                prior_hap *= v.calculate_prior(ref_file)
            if prior_hap > prior_last:
                last = hap
        else:
            merged.append(last)
            last = hap
    if last is not None:
        merged.append(last)
    return merged
