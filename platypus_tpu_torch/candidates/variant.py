"""The Variant model: universal replacement representation, total order,
overlap rules and priors.

Mirrors Platypus src/cython/variant.pyx:100-455: every variant is a
(refPos, removed, added) replacement; ordering is (refName, refPos, varType,
nRemoved); the overlap predicate encodes the SNP-vs-indel same-position
rules; priors are 1e-3/3 per SNP alternative, a mismatch-count geometric for
MNPs, the tandem-context model for indels (see models/error_model.py), 5e-6
for complex replacements, all floored at 1e-10.
"""

from __future__ import annotations

import functools
from typing import Optional

from ..models.error_model import indel_prior

# (ref_name, ref_pos, added, removed) -> prior; see calculate_prior.
_PRIOR_MEMO: dict = {}

PLATYPUS_VAR = 1
FILE_VAR = 2
ASSEMBLER_VAR = 4

SNP, MNP, INS, DEL, REP = range(5)
VAR_TYPE_NAMES = ["SNP", "MNP", "INS", "DEL", "REP"]


@functools.total_ordering
class Variant:
    __slots__ = (
        "ref_name", "ref_pos", "removed", "added", "n_supporting_reads",
        "var_source", "bam_min_pos", "bam_max_pos", "bam_added", "bam_removed",
        "min_ref_pos", "max_ref_pos", "var_type", "_hash", "_prior",
    )

    def __init__(self, ref_name: str, ref_pos: int, removed: bytes, added: bytes,
                 n_supporting_reads: int = 0, var_source: int = PLATYPUS_VAR):
        ref_pos = max(0, ref_pos)
        self.ref_name = ref_name
        self.ref_pos = ref_pos
        self.removed = bytes(removed)
        self.added = bytes(added)
        self.n_supporting_reads = n_supporting_reads
        self.var_source = var_source
        self.bam_min_pos = ref_pos
        self.bam_max_pos = ref_pos
        self.bam_added = self.added
        self.bam_removed = self.removed
        self.min_ref_pos = ref_pos
        self.max_ref_pos = max(ref_pos, ref_pos + self.n_removed - 1)
        if self.n_removed == self.n_added:
            self.var_type = SNP if self.n_added == 1 else MNP
        elif self.n_removed == 0:
            self.var_type = INS
        elif self.n_added == 0:
            self.var_type = DEL
        else:
            self.var_type = REP
        self._hash = hash((self.ref_name, self.ref_pos, self.removed, self.added))

    @property
    def n_added(self) -> int:
        return len(self.added)

    @property
    def n_removed(self) -> int:
        return len(self.removed)

    # -- identity / order ---------------------------------------------------
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (
            self.ref_name == other.ref_name
            and self.ref_pos == other.ref_pos
            and self.added == other.added
            and self.removed == other.removed
        )

    def __lt__(self, other):
        # (refName, refPos, varType, nRemoved) — variant.pyx:304-315.
        return (
            (self.ref_name, self.ref_pos, self.var_type, self.n_removed)
            < (other.ref_name, other.ref_pos, other.var_type, other.n_removed)
        )

    def sort_key(self):
        return (self.ref_name, self.ref_pos, self.var_type, self.n_removed)

    def __repr__(self):
        s = f"{VAR_TYPE_NAMES[self.var_type]}({self.ref_name}:{self.min_ref_pos}-{self.max_ref_pos}"
        if self.n_removed:
            s += " -" + self.removed.decode()
        if self.n_added:
            s += " +" + self.added.decode()
        return s + f" nReads={self.n_supporting_reads}, Source={self.var_source})"

    def short_repr(self):
        s = f"{VAR_TYPE_NAMES[self.var_type]}({self.ref_name}:{self.min_ref_pos}-{self.max_ref_pos}"
        if self.n_removed:
            s += " -" + self.removed.decode()
        if self.n_added:
            s += " +" + self.added.decode()
        return s + ")"

    # -- accumulation --------------------------------------------------------
    def add_variant(self, other: "Variant") -> None:
        """Merge supporting evidence from an equal variant (variant.pyx:261)."""
        self.n_supporting_reads += other.n_supporting_reads
        self.var_source |= other.var_source
        self.bam_min_pos = min(self.bam_min_pos, other.bam_min_pos)
        self.bam_max_pos = max(self.bam_max_pos, other.bam_max_pos)

    # -- overlap rules -------------------------------------------------------
    def overlaps(self, other: "Variant") -> bool:
        """SNP/indel interaction rules (variant.pyx:401-454)."""
        if other.min_ref_pos < self.min_ref_pos < other.max_ref_pos:
            return True
        if self.min_ref_pos < other.min_ref_pos < self.max_ref_pos:
            return True
        if self.min_ref_pos == other.min_ref_pos:
            if self.n_added == self.n_removed and other.n_added == other.n_removed:
                return True
            if (self.var_type == SNP and other.n_added != other.n_removed) or (
                other.var_type == SNP and self.n_added != self.n_removed
            ):
                return False
            return True
        if self.min_ref_pos == other.max_ref_pos:
            if self.n_added == self.n_removed and other.n_added == other.n_removed:
                return True
            if self.n_added != self.n_removed and other.n_added == other.n_removed:
                return False
            return True
        if self.max_ref_pos == other.min_ref_pos:
            if self.n_added == self.n_removed and other.n_added == other.n_removed:
                return True
            if other.n_added != other.n_removed and self.n_added == self.n_removed:
                return False
            return True
        return False

    # -- priors ---------------------------------------------------------------
    def calculate_prior(self, ref_file) -> float:
        """P(variant) prior (variant.pyx:219-259).

        Memoised per instance: the prior is a pure function of the variant
        and the (fixed) reference, and it is re-requested from the
        haplotype-prior, beam-search, and INFO:QD paths — for indels each
        evaluation costs a 200 bp tandem annotation."""
        cached = getattr(self, "_prior", None)
        if cached is not None:
            return cached
        # Process-wide memo: left-normalisation, filtering and window merge
        # re-instantiate equal variants, defeating the per-instance cache;
        # the prior is a pure function of (position, alleles) and the fixed
        # reference, so equal variants share one evaluation.
        key = (self.ref_name, self.ref_pos, self.added, self.removed)
        shared = _PRIOR_MEMO.get(key)
        if shared is not None:
            self._prior = shared
            return shared
        n_added, n_removed = self.n_added, self.n_removed
        if n_added == 1 and n_removed == 1:
            prior = 1e-3 / 3
        elif n_added == n_removed:
            n_diffs = sum(1 for x, y in zip(self.added, self.removed) if x != y)
            prior = 5e-5 * (0.1 ** (n_diffs - 1)) * 0.9
        elif n_added > 0 and n_removed == 0:
            prior = self._indel_prior(ref_file, n_added)
        elif n_added == 0 and n_removed > 0:
            prior = self._indel_prior(ref_file, -n_removed)
        else:
            prior = 5e-6
        self._prior = max(prior, 1e-10)
        if len(_PRIOR_MEMO) < 1_000_000:
            _PRIOR_MEMO[key] = self._prior
        return self._prior

    def _indel_prior(self, ref_file, indel_length_and_type: int) -> float:
        context = 100
        left_pos = max(0, self.ref_pos - context)
        right_pos = self.ref_pos + context
        # The reference fetches [leftPos+1, rightPos+1) (variant.pyx:167).
        sequence = ref_file.get_sequence(self.ref_name, left_pos + 1, right_pos + 1)
        rel_ref_pos = self.ref_pos - left_pos
        return indel_prior(sequence, rel_ref_pos, indel_length_and_type)
