"""The calls held to the planted variants: a VCF's records against the
variants the traffic generator put into each sample's haplotypes.

A planted variant (0-based pos, bases removed, bases added) matches a
record's ALT allele when both, applied to the reference, give the same
sequence over the variant and 30 bp either side: that holds whatever
padding or left alignment the caller chose.  Per sample, the called copy
number of the matched allele (its count in GT) is compared with the
planted one.  A site counts as called when a record of any FILTER
genotypes its allele in some sample; a record counts as extra when it
PASSes and genotypes an allele that matches no planted variant.  Only
sites and records at least EDGE bp inside a region are
counted, so a variant is judged in the one region that calls it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EDGE = 50
FLANK = 30


@dataclass
class Record:
    pos: int            # 0-based
    ref: bytes
    alts: list
    gts: list           # per sample: list of allele indices (None for '.')
    passed: bool        # FILTER is PASS
    line: str


def parse_records(text: str):
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        cols = line.split("\t")
        fmt = cols[8].split(":")
        gi = fmt.index("GT")
        gts = []
        for s in cols[9:]:
            gt = s.split(":")[gi].replace("|", "/").split("/")
            gts.append([None if a == "." else int(a) for a in gt])
        out.append(Record(int(cols[1]) - 1, cols[3].encode(),
                          [a.encode() for a in cols[4].split(",")], gts,
                          cols[6] == "PASS", line))
    return out


def _apply(ref: np.ndarray, lo: int, hi: int, pos: int, removed: int,
           added: bytes) -> bytes:
    return ref[lo:pos].tobytes() + added + ref[pos + removed:hi].tobytes()


@dataclass
class Tally:
    sites: int = 0           # planted sites that some sample carries
    missed: int = 0          # of those, with no matching called allele
    genotypes: int = 0       # (site, sample) pairs of the called sites
    genotype_errors: int = 0  # of those, called copy number != planted
    records: int = 0         # called non-reference alleles of PASS records
    extra: int = 0           # of those, matching no planted variant
    bp: int = 0              # bases judged

    def add(self, other: "Tally") -> None:
        for k in self.__dataclass_fields__:
            setattr(self, k, getattr(self, k) + getattr(other, k))


def judge_region(ref: np.ndarray, start: int, end: int, records, truth) -> Tally:
    """Tally one region's records (parse_records) against `truth`: a list
    of (pos, removed, added, genotype) with genotype [sample][hap] in
    {0, 1}, for the planted variants of the contig."""
    t = Tally(bp=max(0, end - start - 2 * EDGE))
    lo_edge, hi_edge = start + EDGE, end - EDGE
    recs = [r for r in records if lo_edge <= r.pos < hi_edge]
    matched = set()
    for pos, removed, added, gt in truth:
        if not lo_edge <= pos < hi_edge:
            continue
        want = [sum(h) for h in gt]
        if not any(want):
            continue
        t.sites += 1
        lo, hi = pos - FLANK, pos + removed + FLANK
        seq = _apply(ref, lo, hi, pos, removed, added)
        hit = None
        for ri, r in enumerate(recs):
            if r.pos < lo or r.pos + len(r.ref) > hi:
                continue
            for ai, alt in enumerate(r.alts, start=1):
                if _apply(ref, lo, hi, r.pos, len(r.ref), alt) == seq:
                    hit = (ri, ai)
        called = hit is not None and any(
            hit[1] in g for g in recs[hit[0]].gts)
        if not called:
            t.missed += 1
            continue
        matched.add(hit)
        r = recs[hit[0]]
        for g, w in zip(r.gts, want):
            t.genotypes += 1
            t.genotype_errors += int(g.count(hit[1]) != w or None in g)
    for ri, r in enumerate(recs):
        if not r.passed:
            continue
        for ai in range(1, len(r.alts) + 1):
            if any(ai in g for g in r.gts):
                t.records += 1
                t.extra += int((ri, ai) not in matched)
    return t
