"""Candidate variants from a bgzipped+tabixed input VCF.

Mirrors Platypus src/python/variantutils.py (VariantCandidateReader):
multi-allelic sites decompose per ALT; MNPs trim shared leading/trailing
context; indel alleles drop the VCF anchor base and left-trim shared
context; `long_haps` keeps whole replacement alleles (HLA mode).  Lines with
non-ACGTN alleles are skipped.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

from ..candidates.variant import FILE_VAR, Variant
from .tabix import TabixFile

logger = logging.getLogger("platypus_tpu")

_VALID = set("ACGTN")


class VariantCandidateReader:
    def __init__(self, filenames: Sequence[str], long_haps: bool = False,
                 max_size: int = 1500):
        self.files: List[TabixFile] = []
        self.long_haps = long_haps
        self.max_size = max_size
        if isinstance(filenames, (str, bytes)):
            filenames = [filenames]
        for name in filenames:
            if not name.endswith((".gz", ".bgz")):
                raise ValueError(
                    f"Input VCF source {name} must be bgzip-compressed and tabix-indexed"
                )
            self.files.append(TabixFile(name))

    def close(self) -> None:
        for f in self.files:
            f.close()

    def variants(self, chromosome: str, start: int, end: int) -> List[Variant]:
        out = set()
        for f in self.files:
            for cols in f.fetch(chromosome, start, end):
                if len(cols) < 5:
                    continue
                pos = int(cols[1]) - 1  # VCF 1-based -> internal 0-based
                ref = cols[3].upper()
                alts = cols[4].upper().split(",")
                if pos < 0 or set(ref) - _VALID:
                    continue
                if any(set(a) - _VALID for a in alts):
                    continue
                len_ref = len(ref)
                for alt in alts:
                    len_alt = len(alt)
                    if abs(len_alt - len_ref) > self.max_size:
                        continue
                    if len_ref == 1 and len_alt == 1:
                        out.add(Variant(chromosome, pos, ref.encode(), alt.encode(), 0, FILE_VAR))
                    elif len_ref == len_alt:
                        t_ref, t_alt, t_pos = ref, alt, pos
                        while t_ref and t_alt and t_ref[0] == t_alt[0]:
                            t_ref = t_ref[1:]
                            t_alt = t_alt[1:]
                            t_pos += 1
                        while t_ref and t_alt and t_ref[-1] == t_alt[-1]:
                            t_ref = t_ref[:-1]
                            t_alt = t_alt[:-1]
                        out.add(Variant(chromosome, t_pos, t_ref.encode(), t_alt.encode(),
                                        0, FILE_VAR))
                    else:
                        if self.long_haps:
                            out.add(Variant(chromosome, pos, ref.encode(), alt.encode(),
                                            0, FILE_VAR))
                            continue
                        t_ref, t_alt, t_pos = ref[1:], alt[1:], pos
                        while t_ref and t_alt and t_ref[0] == t_alt[0]:
                            t_ref = t_ref[1:]
                            t_alt = t_alt[1:]
                            t_pos += 1
                        out.add(Variant(chromosome, t_pos, t_ref.encode(), t_alt.encode(),
                                        0, FILE_VAR))
        return sorted(out, key=lambda v: v.sort_key())
