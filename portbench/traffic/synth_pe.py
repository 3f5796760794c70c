"""A genome with human-like short tandem repeats, sequenced as a PCR-free
paired-end library, aligned and duplicate-marked as BWA-MEM and a
duplicate marker write it.

The short sites, the haplotypes, the genotypes and the FASTA writer are
synth.py's, the clipping rule synth_long.py's (both imported, not
copied); the records go through harness/bamio_pe.py.  What this generator
adds, each from its traffic file block:

* STR tracts ("str"): one every spacing[0]..spacing[1] bp, written into
  the reference: a unit of period[0]..period[1] bp (drawn evenly; a unit
  that is itself a shorter repeat is drawn again) repeated to a tract of
  length[0]..length[1] bp.  A share "allele_share" of the tracts carries
  an allele of +-units[0]..units[1] whole units (a contraction keeps at
  least one unit), planted like a short site and genotyped with it; short
  sites within "margin" bp of a tract are left out.
* stutter: a read whose alignment spans a tract gains or loses one unit
  (evenly; a loss that would empty the tract is a gain) with probability
  stutter[0] at a 10 bp tract rising linearly to stutter[1] at 60 bp (the
  read's own allele, clipped to 10-60 bp).
* homopolymer errors ("homopolymer_errors": "platypus"): each base of a
  homopolymer run of n bases that a read spans takes a one-base gain or
  loss (evenly) with probability e(n), the per-base indel rates of
  Platypus's homopolymer table (chaplotype.pyx:64-67: 2.9e-5 at n = 1
  rising to 1.8e-2 at n = 49, held there), the table the caller's
  gap-open penalties come from.  On a tract of period 1 they add to its
  stutter.  Outside the tracts a read takes one such error at most (at
  these rates more are negligible), and runs within 10 bp of a planted
  variant take none, so no error lands on a variant.
* pairs ("pairs"): fragments of normal(fragment_mean, fragment_sd) bp,
  and a share tail_share drawn evenly over tail[0]..tail[1] bp; both ends
  read, the leftmost forward (FR).  A fragment under the read length is
  read through into the adapter, which the aligner soft-clips.  A share
  duplicate_share of the pairs is written twice at both mates'
  coordinates, the copy flagged 0x400 and with errors of its own; a
  share improper_share has its second mate improper_distance[0]..[1] bp
  away (either side), 0x2 unset; a share unmapped_mate_share has an
  unmapped second mate, written at its partner's position (0x4 on it,
  0x8 on the partner, TLEN 0).
* the alignments: every indel enters a CIGAR by synth_long.clip_alignment
  (BWA-MEM's default scores; "clipping"), indels left-normalised, BQ and
  MAPQ from the configuration (MAPQ 0 on an unmapped mate).

The truth is every planted variant at its left-normalised position.
reads_per_region counts every record by its position: both mates,
duplicates and unmapped mates.  Everything is drawn from the seed: the
same seed gives the same bytes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from portbench.harness import bamio, bamio_pe
from portbench.traffic import synth
from portbench.traffic.synth_long import SOFT, clip_alignment

PAIRED, PROPER, UNMAP, MUNMAP = 0x1, 0x2, 0x4, 0x8
REVERSE, MREVERSE, READ1, READ2, DUP = 0x10, 0x20, 0x40, 0x80, 0x400
# Platypus's per-base indel error rate in a homopolymer of n bases, n = 1..49
# (chaplotype.pyx:64-67).
HOMOPOLYMER_PER_BASE = np.array(
    [2.9e-5, 2.9e-5, 2.9e-5, 2.9e-5, 4.3e-5, 1.1e-4, 2.4e-4, 5.7e-4, 1.0e-3,
     1.4e-3] + [1.4e-3 + 4.3e-4 * (n - 10) for n in range(11, 50)])
# The TruSeq adapter a read runs into past a short fragment's end.
ADAPTER = np.frombuffer(b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCACATCACGATCTCGTATG"
                        b"CCGTCTTCTGCTTGAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
                        b"AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA",
                        np.uint8)
_COMP = np.frombuffer(bytes.maketrans(b"ACGT", b"TGCA"), np.uint8)


def homopolymer_per_base(n):
    """Per-base probability of a one-base indel error in a run of n bases
    (the table's last entry past 49)."""
    n = np.clip(np.asarray(n, np.int64), 1, len(HOMOPOLYMER_PER_BASE))
    return HOMOPOLYMER_PER_BASE[n - 1]


def homopolymer_rate(n):
    """Probability of a one-base indel error in a run of n <= 49 bases, to
    first order: n times the per-base rate."""
    return np.asarray(n, np.int64) * homopolymer_per_base(n)


def stutter_rate(length, spec):
    lo, hi = spec["stutter"]
    x = (np.clip(length, 10, 60) - 10) / 50.0
    return lo + (hi - lo) * x


def left_normalise(ref: np.ndarray, pos: int, removed: int, added: bytes):
    """An insertion (removed 0) or deletion (added empty) shifted left as
    far as the reference allows; other variants unchanged."""
    if removed == 0 and added:
        seq = bytearray(added)
        while pos > 0 and ref[pos - 1] == seq[-1]:
            seq = seq[-1:] + seq[:-1]
            pos -= 1
        return pos, 0, bytes(seq)
    if removed and not added:
        while pos > 0 and ref[pos - 1] == ref[pos + removed - 1]:
            pos -= 1
    return pos, removed, added


def _has_shorter_period(unit: bytes) -> bool:
    k = len(unit)
    return any(k % p == 0 and unit == unit[:p] * (k // p) for p in range(1, k))


def plant_tracts(ref: np.ndarray, span: int, spec: dict, rng):
    """Write STR tracts into `ref` (in place) every spec['spacing'] bp
    inside [1000, span - 1000): a list of (start, unit bytes, length)."""
    lo, hi = spec["spacing"]
    p_lo, p_hi = spec["period"]
    l_lo, l_hi = spec["length"]
    tracts = []
    pos = 1000
    while True:
        pos += int(rng.integers(lo, hi + 1))
        k = int(rng.integers(p_lo, p_hi + 1))
        length = int(rng.integers(l_lo, l_hi + 1))
        if pos + length >= span - 1000:
            return tracts
        while True:
            unit = synth.ACGT[rng.integers(0, 4, k)].tobytes()
            if not _has_shorter_period(unit):
                break
        tract = (unit * (length // k + 1))[:length]
        ref[pos:pos + length] = np.frombuffer(tract, np.uint8)
        tracts.append((pos, unit, length))


def tract_allele(ref, tract, d: int):
    """The variant that changes `tract` by d units, left-normalised; None
    for d = 0."""
    start, unit, _length = tract
    if d > 0:
        return left_normalise(ref, start, 0, unit * d)
    if d < 0:
        return left_normalise(ref, start, -d * len(unit), b"")
    return None


def plant_alleles(tracts, spec: dict, rng):
    """{tract index: d units} for the tracts that carry an allele."""
    u_lo, u_hi = spec["units"]
    out = {}
    for t, (_start, unit, length) in enumerate(tracts):
        if rng.random() >= spec["allele_share"]:
            continue
        d = int(rng.integers(u_lo, u_hi + 1))
        full = length // len(unit)
        if rng.random() < 0.5 and full > 1:
            d = -min(d, full - 1)
        out[t] = d
    return out


def _clear_of(sites, bounds, margin):
    """The sites farther than `margin` bp from every (lo, hi) of `bounds`
    (sorted)."""
    starts = np.array([b[0] - margin for b in bounds], np.int64)
    ends = np.array([b[1] + margin for b in bounds], np.int64)
    keep = []
    for site in sites:
        p, n = site[0], max(site[1], 1)
        i = int(np.searchsorted(starts, p + n, side="left")) - 1
        if i >= 0 and p < ends[i]:
            continue
        keep.append(site)
    return keep


def _runs(ref: np.ndarray):
    """(start, length) of every homopolymer run of the reference."""
    brk = np.ones(len(ref), bool)
    brk[1:] = ref[1:] != ref[:-1]
    starts = np.nonzero(brk)[0]
    return starts, np.diff(np.append(starts, len(ref)))


def _locate(hap: synth.SimHaplotype, rs: np.ndarray):
    """Hap coordinates of reference positions `rs`, and whether each lies
    on a reference base of the haplotype."""
    i = np.clip(np.searchsorted(hap._ref_rstarts, rs, side="right") - 1,
                0, len(hap._ref_rstarts) - 1)
    ok = ((rs >= hap._ref_rstarts[i])
          & (rs < hap._ref_rstarts[i] + hap._ref_lens[i]))
    return hap._ref_hstarts[i] + (rs - hap._ref_rstarts[i]), ok


def _aligned(hap, h: int, n: int, runs, min_aligned: int):
    """(pos, cigar or None for n M) of hap bases [h, h + n) as the aligner
    writes them, or (None, None) when they would be unmapped."""
    run_s, run_e, run_off = runs
    j = max(0, int(np.searchsorted(run_s, h, side="right")) - 1)
    if run_s[j] <= h and h + n <= run_e[j]:
        return int(h + run_off[j]), None
    pos, cigar = hap.cigar_for(h, n)
    if pos is None:
        return None, None
    pos, cigar = clip_alignment(pos, cigar, min_aligned)
    if pos is None:
        return None, None
    return pos, (None if len(cigar) == 1 else cigar)


def _ref_span(cigar, n):
    if cigar is None:
        return n
    return sum(ln for op, ln in cigar if op in (0, 2))


class _Sample:
    """One sample's haplotypes, with what a read's events need."""

    def __init__(self, ref, haps_vars, tracts, alleles, allele_vars, spec,
                 min_aligned):
        self.ref = ref
        self.vars = [sorted(hv) for hv in haps_vars]
        self.var_pos = [np.array([v[0] for v in hv], np.int64)
                        for hv in self.vars]
        self.haps = [synth.SimHaplotype(ref, hv) for hv in self.vars]
        self.runs = [h.affine_runs() for h in self.haps]
        self.tracts, self.spec, self.min_aligned = tracts, spec, min_aligned
        carried = [set(hv) for hv in self.vars]
        # per hap and tract: the allele's units on that hap
        self.units = [np.array([alleles.get(t, 0) if allele_vars.get(t) in c
                                else 0 for t in range(len(tracts))], np.int64)
                      for c in carried]
        self.allele_vars = allele_vars
        lo = np.array([t[0] for t in tracts], np.int64)
        for t, v in allele_vars.items():
            lo[t] = min(lo[t], v[0])
        self.t_lo = lo
        self.t_hi = np.array([t[0] + t[2] for t in tracts], np.int64)

    def read(self, k, h, n):
        return _aligned(self.haps[k], h, n, self.runs[k], self.min_aligned)

    def rebuilt(self, k, h, n, tract, d, error):
        """Hap k's bases from h, n of them, with tract `tract` at d units
        (None: as on the hap) and the one-base `error` variant added:
        (pos, cigar or None, seq), or None where h is not a reference base
        of the haplotype or the read would be unmapped."""
        hap = self.haps[k]
        b = max(0, int(np.searchsorted(hap._ref_hstarts, h, side="right")) - 1)
        hs = int(hap._ref_hstarts[b])
        if not hs <= h < hs + int(hap._ref_lens[b]):
            return None
        r0 = int(hap._ref_rstarts[b]) + (h - hs)
        r1 = min(len(self.ref), r0 + n + 400)
        old = self.allele_vars.get(tract) if tract is not None else None
        local = []
        lo, hi = np.searchsorted(self.var_pos[k], [r0, r1 - 50])
        for p, rem, add in self.vars[k][lo:hi]:
            if (p, rem, add) == old:
                continue
            if (p > r0 or (p == r0 and rem == len(add))) and p < r1 - 50:
                local.append((p - r0, rem, add))
        if tract is not None and d:
            p, rem, add = tract_allele(self.ref, self.tracts[tract], d)
            local.append((p - r0, rem, add))
        if error is not None:
            local.append((error[0] - r0, error[1], error[2]))
        sim = synth.SimHaplotype(self.ref[r0:r1], sorted(local))
        if len(sim.seq) < n:
            return None
        pos, cigar = sim.cigar_for(0, n)
        if pos is None:
            return None
        pos, cigar = clip_alignment(pos + r0, cigar, self.min_aligned)
        if pos is None:
            return None
        return pos, (None if len(cigar) == 1 else cigar), sim.seq[:n].copy()


def simulate_pairs(sample: _Sample, length: int, L: int, coverage: float,
                   pairs: dict, homopolymer: bool, rng, err_rng, ev_rng,
                   error_rate: float):
    """The sample's records, sorted by position: a dict of numpy arrays
    (pos, flag, mapq, mate_pos, tlen, name_id, seq [n, L]), the {row:
    cigar} of every record that is not L M ([] for an unmapped one), and
    a summary of what was drawn."""
    n_frag = int(length * coverage / (2 * L))
    mean, sd = pairs["fragment_mean"], pairs["fragment_sd"]
    t_lo, t_hi = pairs["tail"]
    frag = np.rint(rng.normal(mean, sd, n_frag)).astype(np.int64)
    tail = rng.random(n_frag) < pairs["tail_share"]
    frag[tail] = rng.integers(t_lo, t_hi + 1, int(tail.sum()))
    frag = np.clip(frag, t_lo, 3 * mean)
    kind = rng.random(n_frag)
    improper = kind < pairs["improper_share"]
    unmapped = ~improper & (kind < pairs["improper_share"]
                            + pairs["unmapped_mate_share"])
    dup = ~improper & ~unmapped & (rng.random(n_frag)
                                   < pairs["duplicate_share"])
    d_lo, d_hi = pairs["improper_distance"]
    far = rng.integers(d_lo, d_hi + 1, n_frag) * np.where(
        rng.random(n_frag) < 0.5, -1, 1)
    first_is_r1 = rng.random(n_frag) < 0.5
    hap_of = rng.integers(0, 2, n_frag)
    margin = 3 * mean + L
    rs = rng.integers(margin, length - margin, n_frag)
    far_rs = np.clip(rs + far, margin, length - margin)
    event_u = rng.random(2 * n_frag)
    event_u2 = rng.random(2 * n_frag)
    event_dir = np.where(rng.random(2 * n_frag) < 0.5, -1, 1)

    # the two reads of each fragment: rows f (A, leftmost, forward) and
    # n_frag + f (B)
    h = np.zeros(n_frag, np.int64)
    hf = np.zeros(n_frag, np.int64)
    ok = np.zeros(n_frag, bool)
    for k in range(2):
        sel = hap_of == k
        hk, okk = _locate(sample.haps[k], rs[sel])
        hfk, okf = _locate(sample.haps[k], far_rs[sel])
        room = len(sample.haps[k].seq)
        h[sel], hf[sel] = hk, hfk
        ok[sel] = (okk & (hk + np.maximum(frag[sel], L) <= room)
                   & (~improper[sel] | (okf & (hfk + L <= room))))
    short = frag < L
    n_a = np.minimum(frag, L)
    h_b = np.where(improper, hf, np.where(short, h, h + frag - L))
    rows_k = np.concatenate([hap_of, hap_of])
    rows_h = np.concatenate([h, h_b])
    rows_n = np.concatenate([n_a, n_a])
    allow = np.concatenate([~short, ~short & ~unmapped])
    live = np.concatenate([ok, ok])

    # alignments: one affine run is n M at its offset, the rest by
    # cigar_for and the clipping rule
    R = 2 * n_frag
    pos = np.full(R, -1, np.int64)
    single = np.zeros(R, bool)
    for k in range(2):
        run_s, run_e, run_off = sample.runs[k]
        sel = np.nonzero(live & (rows_k == k))[0]
        j = np.clip(np.searchsorted(run_s, rows_h[sel], side="right") - 1, 0,
                    len(run_s) - 1)
        one = ((rows_h[sel] >= run_s[j])
               & (rows_h[sel] + rows_n[sel] <= run_e[j]))
        pos[sel[one]] = rows_h[sel[one]] + run_off[j[one]]
        single[sel[one]] = True
    cigars = {}
    for r in np.nonzero(live & ~single)[0]:
        r = int(r)
        p, c = sample.read(int(rows_k[r]), int(rows_h[r]), int(rows_n[r]))
        if p is None:
            live[r] = live[(r + n_frag) % R] = False
            continue
        pos[r] = p
        if c is not None:
            cigars[r] = c
    end = pos + rows_n
    for r, c in cigars.items():
        end[r] = pos[r] + _ref_span(c, int(rows_n[r]))

    # events: a spanned tract's stutter (and homopolymer error at period
    # 1), else a homopolymer error of a run the read spans
    runs_s, runs_n = _runs(sample.ref)
    rate = homopolymer_rate(runs_n) if homopolymer else np.zeros(len(runs_s))
    blocked = np.zeros(len(sample.ref) + 1, np.int64)
    for hv in sample.vars:
        for p, rem, _a in hv:
            blocked[max(0, p - 10):p + max(rem, 1) + 10] = 1
    blocked = np.concatenate([[0], np.cumsum(blocked)])
    rate[blocked[runs_s + runs_n] > blocked[runs_s]] = 0.0
    for a, b in zip(np.searchsorted(runs_s, sample.t_lo - 10),
                    np.searchsorted(runs_s, sample.t_hi + 10)):
        rate[max(0, a - 1):b] = 0.0
    cum = np.concatenate([[0.0], np.cumsum(rate)])
    T = len(sample.tracts)
    period = np.array([len(t[1]) for t in sample.tracts], np.int64)
    t_len = np.array([t[2] for t in sample.tracts], np.int64)
    cand = np.nonzero(live & allow)[0]
    t = np.searchsorted(sample.t_lo, pos[cand] + 3, side="left")
    tc = np.minimum(t, T - 1)
    spans = (t < T) & (sample.t_hi[tc] + 3 <= end[cand])
    units = np.stack(sample.units)[rows_k[cand], tc]
    bases = t_len[tc] + units * period[tc]
    u = event_u[cand]
    step = np.where(u < np.where(spans, stutter_rate(bases, sample.spec), 0.0),
                    event_dir[cand], 0)
    stutter = step != 0
    if homopolymer:
        # a tract of period 1 is a homopolymer: each of its bases takes a
        # one-base gain or loss at the table's per-base rate
        n_err = np.where(spans & (period[tc] == 1), ev_rng.binomial(
            np.maximum(bases, 0), homopolymer_per_base(bases)), 0)
        step = step + 2 * ev_rng.binomial(n_err, 0.5) - n_err
    # a tract keeps one unit
    step = np.maximum(step, 1 - bases // period[tc])
    in_tract = spans & (step != 0)
    lo = np.searchsorted(runs_s, pos[cand] + 2)
    hi = np.maximum(lo, np.searchsorted(runs_s, end[cand] - 12))
    u2 = event_u2[cand]
    hp = ~spans & (u2 < cum[hi] - cum[lo])
    run_of = np.searchsorted(cum, cum[lo] + u2, side="right") - 1
    summary = dict(stutter=int(stutter.sum()), tract_changed=int(in_tract.sum()),
                   homopolymer=int(hp.sum()))
    rebuilt = {}
    for i in np.nonzero(in_tract | hp)[0]:
        r = int(cand[i])
        k = int(rows_k[r])
        if in_tract[i]:
            got = sample.rebuilt(k, int(rows_h[r]), int(rows_n[r]), int(tc[i]),
                                 int(units[i] + step[i]), None)
        else:
            s0 = int(runs_s[run_of[i]])
            err = ((s0, 1, b"") if event_dir[r] < 0
                   else (s0, 0, bytes([int(sample.ref[s0])])))
            got = sample.rebuilt(k, int(rows_h[r]), int(rows_n[r]), None,
                                 None, err)
        if got is None:
            continue
        pos[r], c, rebuilt[r] = got
        cigars.pop(r, None)
        if c is not None:
            cigars[r] = c
        end[r] = pos[r] + _ref_span(c, int(rows_n[r]))

    # sequences: hap bases, the adapter past a short fragment's end
    seq = np.empty((R, L), np.uint8)
    col = np.arange(L)[None, :]
    for k in range(2):
        sel = np.nonzero(live & (rows_k == k))[0]
        hs = sample.haps[k].seq
        idx = np.minimum(rows_h[sel][:, None] + col, len(hs) - 1)
        seq[sel] = hs[idx]
    for r, s_ in rebuilt.items():
        seq[r] = s_
    radapter = _COMP[ADAPTER][::-1]
    for f in np.nonzero(ok & short)[0]:
        for r in (int(f), int(f) + n_frag):
            F = int(frag[f])
            clip = L - F
            body = sample.haps[int(rows_k[r])].seq[rows_h[r]:rows_h[r] + F]
            c = cigars.get(r, [(0, F)])
            if r < n_frag:
                seq[r] = np.concatenate([body, ADAPTER[:clip]])
                cigars[r] = list(c) + [(SOFT, clip)]
            else:
                seq[r] = np.concatenate([radapter[len(radapter) - clip:],
                                         body])
                cigars[r] = [(SOFT, clip)] + list(c)

    # the records: flags, mates, TLEN; unmapped mates; duplicates
    fr = np.nonzero(live[:n_frag] & live[n_frag:])[0]
    a_r, b_r = fr, fr + n_frag
    ra = np.where(first_is_r1[fr], READ1, READ2)
    rb = np.where(first_is_r1[fr], READ2, READ1)
    um = unmapped[fr]
    left = np.minimum(pos[a_r], pos[b_r])
    tl = np.maximum(end[a_r], end[b_r]) - left
    a_first = pos[a_r] <= pos[b_r]
    proper = np.where(improper[fr], 0, PROPER)
    flag_a = np.where(um, PAIRED | MUNMAP | ra, PAIRED | MREVERSE | ra | proper)
    flag_b = np.where(um, PAIRED | UNMAP | rb, PAIRED | REVERSE | rb | proper)
    pos_b = np.where(um, pos[a_r], pos[b_r])
    tlen_a = np.where(um, 0, np.where(a_first, tl, -tl))
    tlen_b = np.where(um, 0, -tlen_a)
    mate_a = np.where(um, pos[a_r], pos[b_r])
    name = 2 * np.arange(len(fr), dtype=np.int64)
    rows = np.concatenate([a_r, b_r])
    rec = dict(pos=np.concatenate([pos[a_r], pos_b]),
               flag=np.concatenate([flag_a, flag_b]),
               mate_pos=np.concatenate([mate_a, pos[a_r]]),
               tlen=np.concatenate([tlen_a, tlen_b]),
               name_id=np.concatenate([name, name]))
    d = np.nonzero(dup[fr])[0]
    dd = np.concatenate([d, d + len(fr)])
    for key in rec:
        rec[key] = np.concatenate([rec[key], rec[key][dd]])
    rec["flag"][len(rows):] |= DUP
    rec["name_id"][len(rows):] += 1
    rows = np.concatenate([rows, rows[dd]])
    no_cigar = np.concatenate([np.zeros(len(fr), bool), um,
                               np.zeros(len(dd), bool)])
    order = np.argsort(rec["pos"], kind="stable")
    for key in rec:
        rec[key] = rec[key][order]
    src = rows[order]
    rec["seq"] = seq[src]
    if error_rate > 0:
        m = err_rng.random(rec["seq"].shape) < error_rate
        rec["seq"][m] = synth.ACGT[err_rng.integers(0, 4, size=int(m.sum()))]
    rec["mapq"] = np.where(rec["flag"] & UNMAP, 0, 60)
    no_cigar = no_cigar[order]
    out = {int(i): [] for i in np.nonzero(no_cigar)[0]}
    with_cigar = ~no_cigar & np.isin(src, np.fromiter(cigars, np.int64,
                                                      len(cigars)))
    for i in np.nonzero(with_cigar)[0]:
        out[int(i)] = [tuple(x) for x in cigars[int(src[i])]]
    summary.update(fragments=len(fr), duplicated=len(d),
                   improper=int(improper[fr].sum()), unmapped_mate=int(um.sum()),
                   under_300=int((frag[fr] < 300).sum()),
                   under_150=int(short[fr].sum()))
    return rec, out, summary


def build(workdir: str, config: dict, traffic: dict, seed: int) -> dict:
    """Write the dataset of (config, traffic, seed) into `workdir`, laid out
    as synth.build lays it out (ref.fa, one BAM per sample, meta.json);
    meta.json also holds the tracts ([start, period, length]) under "str"
    and what each sample's draw gave under "drawn"."""
    contig, length = config["contig"], int(config["genome_length"])
    L = int(config["read_length"])
    spec, str_spec = traffic["variants"], traffic["str"]
    ref = synth.ACGT[synth._rng(seed, 0).integers(0, 4, size=length)]
    tracts = plant_tracts(ref, length, str_spec, synth._rng(seed, 2))
    bamio.write_fasta(os.path.join(workdir, "ref.fa"), contig, ref)
    site_rng = synth._rng(seed, 1)
    short = [left_normalise(ref, *s) for s in
             synth.plant_sites(ref, length, spec, site_rng)]
    bounds = [(s, s + n) for s, _u, n in tracts]
    short = _clear_of(short, bounds, int(str_spec["margin"]))
    alleles = plant_alleles(tracts, str_spec, synth._rng(seed, 3))
    allele_vars = {t: tract_allele(ref, tracts[t], d)
                   for t, d in alleles.items()}
    sites = sorted(short + list(allele_vars.values()))
    carried = synth.genotypes(sites, int(config["samples"]), spec, site_rng)
    region = int(config["platypus"]["buffer_size"])
    edges = np.arange(0, length + region, region)
    edges[-1] = min(edges[-1], length)
    reads_per_region = np.zeros(len(edges) - 1, np.int64)
    min_aligned = int(traffic["clipping"]["min_aligned"])
    homopolymer = traffic.get("homopolymer_errors") == "platypus"
    bams, truth, drawn = [], {}, []
    for s, haps_vars in enumerate(carried):
        name = f"S{s:03d}"
        sample = _Sample(ref, haps_vars, tracts, alleles, allele_vars,
                         str_spec, min_aligned)
        recs, cigars, summary = simulate_pairs(
            sample, length, L, float(traffic["coverage"]), traffic["pairs"],
            homopolymer, synth._rng(seed, 10 + 3 * s),
            synth._rng(seed, 11 + 3 * s), synth._rng(seed, 12 + 3 * s),
            float(config["error_rate"]))
        bamio_pe.write_bam(os.path.join(workdir, f"{name}.bam"), contig,
                           length, recs["pos"], recs["flag"], recs["mapq"],
                           recs["mate_pos"], recs["tlen"], recs["name_id"],
                           recs["seq"], cigars, int(config["base_quality"]),
                           name)
        bams.append(f"{name}.bam")
        drawn.append(summary)
        reads_per_region += np.histogram(recs["pos"], bins=edges)[0]
        for h, hv in enumerate(haps_vars):
            for p, n, alt in hv:
                gt = truth.setdefault(f"{p}:{n}:{alt.decode()}",
                                      [[0, 0] for _ in carried])
                gt[s][h] = 1
    regions = [[contig, int(a), int(b)] for a, b in zip(edges[:-1], edges[1:])]
    meta = dict(ref="ref.fa", bams=bams, regions=regions,
                reads_per_region=reads_per_region.tolist(), truth=truth,
                str=[[int(a), len(u), int(n)] for a, u, n in tracts],
                drawn=drawn)
    with open(os.path.join(workdir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return meta
