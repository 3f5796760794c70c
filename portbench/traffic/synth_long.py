"""A genome with long insertions and deletions, and reads written as a
local aligner writes them: soft-clipped at a breakpoint it does not align
through.

The short sites, the haplotypes, the read draw and the writers are
synth.py's (imported, not copied).  What this generator adds:

* long events ("long_events" in the traffic file): one every
  spacing[0]..spacing[1] bp, length[0]..length[1] bp drawn log-uniformly,
  an insertion with probability "ins" and else a deletion; short sites
  within "margin" bp of a long event are left out, so no two planted
  variants overlap.  Long and short sites then share synth.genotypes.
* the reads' alignments ("clipping"): synth.py writes every indel into
  the CIGAR, of any length.  A local aligner such as BWA-MEM (match 1,
  gap open 6, extend 1, clip 5) aligns through an event of n bp only
  where both sides of the read hold more than n + 1 matching bases; else
  it soft-clips the shorter side and places the read by the longer one.
  clip_alignment applies that rule, event by event, the event with the
  shortest side first.  A read left with fewer than "min_aligned" bases
  on the reference is unmapped: it is not written and not counted.

Everything is drawn from the seed: the same seed gives the same bytes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from portbench.harness import bamio
from portbench.traffic import synth

M, INS, DEL, SOFT = 0, 1, 2, 4
_QUERY = (M, INS, SOFT)   # ops that consume read bases
_REF = (M, DEL)           # ops that consume reference bases


def plant_long_events(ref: np.ndarray, span: int, spec: dict, rng):
    """Long events every spec['spacing'] bp inside [1000, span - 1000): a
    list of (pos, removed_len, added_bytes)."""
    lo, hi = spec["spacing"]
    lmin, lmax = spec["length"]
    events = []
    pos = 1000
    while True:
        pos += int(rng.integers(lo, hi + 1))
        n = int(np.exp(rng.uniform(np.log(lmin), np.log(lmax + 1))))
        n = min(max(n, lmin), lmax)
        if pos + n >= span - 1000:
            return events
        if rng.random() < spec["ins"]:
            events.append((pos, 0, synth.ACGT[rng.integers(0, 4, n)].tobytes()))
        else:
            events.append((pos, n, b""))


def merge_sites(short, long_, margin: int):
    """The short sites clear of every long event by `margin` bp, and the
    long events, sorted by position."""
    starts = np.array([p - margin for p, _n, _a in long_], np.int64)
    ends = np.array([p + max(n, 1) + margin for p, n, _a in long_], np.int64)
    keep = []
    for site in short:
        p, n = site[0], max(site[1], 1)
        i = int(np.searchsorted(starts, p + n, side="left")) - 1
        if i >= 0 and p < ends[i]:
            continue
        keep.append(site)
    return sorted(keep + list(long_))


def clip_alignment(pos: int, cigar, min_aligned: int):
    """(pos, cigar) of a read as a local aligner writes it (module
    docstring), or (None, None) when the read is left unmapped."""
    ops = [list(c) for c in cigar]
    while True:
        total = sum(ln for op, ln in ops if op == M)
        worst = None
        left = 0
        for i, (op, ln) in enumerate(ops):
            if op == M:
                left += ln
            elif op in (INS, DEL):
                side = min(left, total - left)
                if side <= ln + 1 and (worst is None or side < worst[0]):
                    worst = (side, i, left)
        if worst is None:
            break
        _side, i, left = worst
        if left <= total - left:   # the left side is the shorter: clip it
            pos += sum(ln for op, ln in ops[:i + 1] if op in _REF)
            q = sum(ln for op, ln in ops[:i + 1] if op in _QUERY)
            ops = [[SOFT, q]] + ops[i + 1:]
        else:
            q = sum(ln for op, ln in ops[i:] if op in _QUERY)
            ops = ops[:i] + [[SOFT, q]]
    if sum(ln for op, ln in ops if op == M) < min_aligned:
        return None, None
    return pos, [tuple(c) for c in ops if c[1] > 0]


def clip_reads(pos: np.ndarray, seq: np.ndarray, special: dict,
               min_aligned: int):
    """synth.simulate_reads's output with every multi-op alignment put
    through clip_alignment: unmapped reads dropped, the rest sorted by
    their new position (stably)."""
    pos = pos.copy()
    keep = np.ones(len(pos), bool)
    out = {}
    for r, cigar in special.items():
        p, c = clip_alignment(int(pos[r]), cigar, min_aligned)
        if p is None:
            keep[r] = False
            continue
        pos[r] = p
        if len(c) > 1:
            out[r] = c
    rows = np.nonzero(keep)[0]
    order = rows[np.argsort(pos[rows], kind="stable")]
    new_row = np.full(len(pos), -1, np.int64)
    new_row[order] = np.arange(len(order))
    return (pos[order], seq[order],
            {int(new_row[r]): c for r, c in out.items()})


def build(workdir: str, config: dict, traffic: dict, seed: int) -> dict:
    """Write the dataset of (config, traffic, seed) into `workdir`, laid out
    as synth.build lays it out (ref.fa, one BAM per sample, meta.json);
    meta.json also lists the long events' truth keys under "long"."""
    contig, length = config["contig"], int(config["genome_length"])
    L = int(config["read_length"])
    ref = synth.ACGT[synth._rng(seed, 0).integers(0, 4, size=length)]
    bamio.write_fasta(os.path.join(workdir, "ref.fa"), contig, ref)
    spec = traffic["variants"]
    long_spec = traffic["long_events"]
    site_rng = synth._rng(seed, 1)
    short = synth.plant_sites(ref, length, spec, site_rng)
    long_ = plant_long_events(ref, length, long_spec, synth._rng(seed, 2))
    sites = merge_sites(short, long_, int(long_spec["margin"]))
    carried = synth.genotypes(sites, int(config["samples"]), spec, site_rng)
    region = int(config["platypus"]["buffer_size"])
    edges = np.arange(0, length + region, region)
    edges[-1] = min(edges[-1], length)
    reads_per_region = np.zeros(len(edges) - 1, np.int64)
    min_aligned = int(traffic["clipping"]["min_aligned"])
    bams, truth = [], {}
    for s, haps_vars in enumerate(carried):
        name = f"S{s:03d}"
        haps = [synth.SimHaplotype(ref, hv) for hv in haps_vars]
        pos, seq, special = synth.simulate_reads(
            haps, 0, length, L, float(traffic["coverage"]),
            synth._rng(seed, 10 + 2 * s), synth._rng(seed, 11 + 2 * s),
            float(config["error_rate"]))
        pos, seq, special = clip_reads(pos, seq, special, min_aligned)
        bamio.write_bam(os.path.join(workdir, f"{name}.bam"), contig, length,
                        pos, seq, special, int(config["base_quality"]),
                        int(config["mapq"]), name)
        bams.append(f"{name}.bam")
        reads_per_region += np.histogram(pos, bins=edges)[0]
        for h, hv in enumerate(haps_vars):
            for p, n, alt in hv:
                gt = truth.setdefault(f"{p}:{n}:{alt.decode()}",
                                      [[0, 0] for _ in carried])
                gt[s][h] = 1
    long_keys = sorted(f"{p}:{n}:{a.decode()}" for p, n, a in long_
                       if f"{p}:{n}:{a.decode()}" in truth)
    regions = [[contig, int(a), int(b)] for a, b in zip(edges[:-1], edges[1:])]
    meta = dict(ref="ref.fa", bams=bams, regions=regions,
                reads_per_region=reads_per_region.tolist(), truth=truth,
                long=long_keys)
    with open(os.path.join(workdir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return meta
