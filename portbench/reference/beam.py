"""The plain beam search for a dense window's haplotypes: Platypus's
getFilteredHaplotypes past log2(maxHaplotypes - 1) variants
(variantFilter.pyx:440-506), in plain Python, numpy and torch.  It imports
nothing of the program and no JAX; alignments are reference/dp.py's plain
DP.

haplotype_sets(window, variants, reads, ref, rlen) returns the variant
sets of the haplotypes the search keeps, best first, each a tuple of
indices into `variants`:

* the window's good reads are coverage-subsampled per sample: a sample's
  rows taken at a stride of max(1, (its first read's length x its reads
  // the window's width) // coverage_sampling_level), in the order given;
* the variants are taken by support, most first (ties in the order
  given); each round scores the variant alone and the variant joined to
  each set kept so far that it does not collide with, and keeps the best
  max_haplotypes - 1 sets in a heap keyed by (score, the sets' variant
  keys), as Platypus's heap is;
* a set's score is the best over samples of the sum over the sample's
  subsampled reads of ln(1/2 e^ref + 1/2 e^hap), the reads'
  log-likelihoods on the reference haplotype and on the set's (float64);
* a read's log-likelihood on a haplotype (chaplotype.pyx:619-676): 0 if it
  overlaps the window by under 7 bases, else max(-300, -ln(10)/10 x score
  + ln(1 - 10^(-MAPQ/10))), the score the least of the banded DP's over
  the read's anchors on the haplotype: the offsets where most of its
  7-mers land that leave the band room (calign.pyx:25-272), and its
  mapped position, each aligned from 8 bases to its left; a read under 7
  bases scores 0;
* a haplotype is the window's reference with the set spliced in (an
  indel keeps its anchor base) and min(2 rlen, 500) bases of reference
  either side, the reference read as Platypus's FASTA reader reads it
  (its last base never returned); its gap-open penalties are Platypus's
  homopolymer table (chaplotype.pyx:64-67, :552-590).

Departures from the description: the window's reads and candidate
variants are taken as given (the caller gathers and generates them; this
checks what it does with them), and each round's DP runs as one batch.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from portbench.reference import dp

HASH = 7
MLTOT = -0.23025850929940459  # -ln(10)/10
_PER_BASE = ([2.9e-5, 2.9e-5, 2.9e-5, 2.9e-5, 4.3e-5, 1.1e-4, 2.4e-4, 5.7e-4,
              1.0e-3, 1.4e-3] + [1.4e-3 + 4.3e-4 * (n - 10) for n in range(11, 50)])
HOMOPOLQ = np.array([int(33.5 + 10 * math.log((i + 1) * q) / math.log(0.1))
                     - 33 for i, q in enumerate(_PER_BASE)], np.int32)
SNP, MNP, INS, DEL, REP = range(5)


class Var:
    """A candidate: position (the anchor base of an indel), removed and
    added bases, supporting reads; ordered by (position, type, bases
    removed) and equal by alleles, as Platypus's variants are."""

    def __init__(self, pos: int, removed: bytes, added: bytes, support: int):
        self.pos, self.removed, self.added = pos, removed, added
        self.support = support
        nr, na = len(removed), len(added)
        self.type = ((SNP if na == 1 else MNP) if nr == na else INS if nr == 0
                     else DEL if na == 0 else REP)
        self.lo, self.hi = pos, max(pos, pos + nr - 1)

    def key(self):
        return (self.pos, self.type, len(self.removed))

    def __eq__(self, other):
        return (self.pos, self.removed, self.added) == (
            other.pos, other.removed, other.added)

    def __lt__(self, other):
        return self.key() < other.key()


def valid(combo) -> bool:
    """No two variants of the set collide (a SNP or MNP may abut an indel
    after it)."""
    for a, b in zip(combo, combo[1:]):
        if a.hi > b.lo:
            return False
        if a.hi == b.lo:
            if len(a.added) == len(a.removed) and len(b.added) != len(b.removed):
                continue
            return False
    return True


class Reference:
    """One contig as Platypus's FASTA reader serves it."""

    def __init__(self, seq: bytes):
        self.seq = seq

    def get(self, start: int, end: int) -> bytes:
        start, end = max(0, start), min(end, len(self.seq) - 1)
        return self.seq[start:end] if end > start else b""


def haplotype(ref: Reference, start: int, end: int, combo, rlen: int):
    """(sequence, its first base's position) of the window [start, end)
    with `combo` spliced in."""
    start, end = max(0, start), min(end, len(ref.seq) - 1)
    pad = min(2 * rlen, 500)
    middle = []
    at = start
    for v in combo:
        if v.pos > at:
            middle.append(ref.get(at, v.pos))
            at = v.pos
        if len(v.added) == len(v.removed):
            middle.append(v.added)
            at += len(v.removed)
            continue
        if (not v.added or not v.removed) and v.pos == at:
            middle.append(ref.get(v.pos, v.pos + 1))
            at += 1
        at += len(v.removed)
        middle.append(v.added)
    if at < end:
        middle.append(ref.get(at, end))
    body = b"".join(middle) if combo else ref.get(start, end)
    return ref.get(start - pad, start) + body + ref.get(end, end + pad), start - pad


def gap_open(seq: bytes) -> np.ndarray:
    """Per base: the table's penalty for the bases left in its homopolymer
    run (an N breaks every run), filled from the back."""
    out = np.zeros(len(seq), np.int32)
    run = 0
    for i in range(len(seq) - 1, -1, -1):
        if i + 1 < len(seq) and seq[i] == seq[i + 1] and seq[i] != 78 \
                and seq[i + 1] != 78:
            run = min(run + 1, len(HOMOPOLQ) - 1)
        else:
            run = 0
        out[i] = HOMOPOLQ[run]
    return out


def _code(b: int) -> int:
    c = b & 7
    return (2 if c == 7 else c) & 3


def _hashes(seq: bytes, n: int):
    """The 7-mer hashes at offsets 0..n-1."""
    codes = [_code(b) for b in seq]
    out = []
    for i in range(n):
        h = 0
        for c in codes[i:i + HASH]:
            h = h * 4 + c
        out.append(h)
    return out


def kmer_index(hap: bytes):
    """{7-mer hash: its offsets} over offsets 0..len - 8."""
    where = {}
    for p, h in enumerate(_hashes(hap, max(0, len(hap) - HASH))):
        where.setdefault(h, []).append(p)
    return where


def anchors(hap: bytes, where: dict, hap_start: int, read: bytes,
            read_pos: int):
    """The read's segment starts on the haplotype (`where`: its
    kmer_index)."""
    rl, hl = len(read), len(hap)
    if rl < HASH:
        return []
    votes = {}
    for k, h in enumerate(_hashes(read, rl - HASH)):
        for p in where.get(h, ()):
            votes[p - k] = votes.get(p - k, 0) + 1
    segs = []
    if votes:
        best = max(votes.values())
        segs = [max(0, a - 8) for a, c in sorted(votes.items())
                if c == best and a >= -rl and a + rl + 15 < hl]
    segs.append(max(0, min(read_pos - hap_start, hl - rl - 15) - 8))
    return sorted(set(segs))


def read_logliks(haps, reads, rows, win_start, win_end, device="cpu"):
    """[H, len(rows)] float64 log-likelihoods of the reads' rows on each
    (sequence, first position) of `haps`."""
    H = len(haps)
    out = np.zeros((H, len(rows)), np.float64)
    if not len(rows):
        return out
    rl = reads["rlen"][rows].astype(np.int64)
    overlap = (np.minimum(reads["end"][rows], win_end)
               - np.maximum(reads["pos"][rows], win_start))
    live = [j for j in range(len(rows)) if overlap[j] >= HASH]
    if not live:
        return out
    L2 = max(32, -(-int(rl[live].max()) // 32) * 32)
    width = max(len(s) for s, _ in haps) + L2 + 15
    hap_mat = np.full((H, width), ord("N"), np.uint8)
    go_mat = np.zeros((H, width), np.int32)
    for h, (s, _p) in enumerate(haps):
        hap_mat[h, :len(s)] = np.frombuffer(s, np.uint8)
        go_mat[h, :len(s)] = gap_open(s)
    seq_mat = np.zeros((len(live), L2), np.uint8)
    qual_mat = np.zeros((len(live), L2), np.uint8)
    pair_h, pair_r, pair_s, owner = [], [], [], []
    index = [kmer_index(s) for s, _p in haps]
    for a, j in enumerate(live):
        r = rows[j]
        n = int(rl[j])
        seq_mat[a, :n] = reads["seq"][r, :n]
        qual_mat[a, :n] = reads["qual"][r, :n]
        read = bytes(reads["seq"][r, :n])
        for h, (s, p) in enumerate(haps):
            for seg in anchors(s, index[h], p, read, int(reads["pos"][r])):
                pair_h.append(h)
                pair_r.append(a)
                pair_s.append(seg)
                owner.append((h, j))
    score = np.full((H, len(rows)), np.iinfo(np.int64).max, np.int64)
    for j in live:
        if rl[j] < HASH:
            score[:, j] = 0
    if pair_h:
        t = lambda x, dt=torch.int32: torch.as_tensor(np.asarray(x), dtype=dt,
                                                      device=device)
        got = dp.band_align_pairs(
            t(hap_mat, torch.uint8), t(go_mat), t(seq_mat, torch.uint8),
            t(qual_mat, torch.uint8), t(pair_h), t(pair_r), t(pair_s),
            t(rl[live][pair_r])).cpu().numpy()
        for (h, j), sc in zip(owner, got):
            score[h, j] = min(score[h, j], int(sc))
    mapq = reads["mapq"][rows].astype(np.float64)
    with np.errstate(divide="ignore"):
        right = np.log(1.0 - np.exp(MLTOT * mapq))
    for j in live:
        out[:, j] = np.maximum(-300.0, MLTOT * score[:, j].astype(np.float64)
                               + right[j])
    return out


def subsample(reads, width: int, level: int, n_samples: int):
    """Each sample's good rows at its stride (module docstring)."""
    rows = []
    for s in range(n_samples):
        idx = np.nonzero((reads["sample"] == s) & reads["good"])[0]
        if not len(idx):
            continue
        cov = int(reads["rlen"][idx[0]]) * len(idx) // max(1, width)
        rows.append(idx[::max(1, cov // max(1, level))])
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


def haplotype_sets(window, variants, reads, ref: bytes, rlen: int,
                   n_samples: int = 1, max_haplotypes: int = 50,
                   coverage_sampling_level: int = 30, device="cpu",
                   tally=None):
    """The kept haplotypes' variant sets, best first (module docstring).
    window: (start, end); variants: [(pos, removed, added, support)];
    reads: the window's reads as numpy arrays under seq [R, L], qual, rlen,
    pos, end, mapq, good and sample.  `tally`, a dict, gains the rounds
    ("rounds") and the haplotypes they scored ("candidates")."""
    start, end = window
    contig = Reference(ref)
    vs = [Var(*v) for v in variants]
    index = {id(v): i for i, v in enumerate(vs)}
    keep = max_haplotypes - 1
    rows = subsample(reads, end - start, coverage_sampling_level, n_samples)
    samples = [np.nonzero(reads["sample"][rows] == s)[0]
               for s in range(n_samples)]
    samples = [m for m in samples if len(m)]
    win_lo = max(0, start)
    win_hi = min(end, len(ref) - 1)
    ref_hap = haplotype(contig, start, end, (), rlen)
    heap = []
    for v in sorted(vs, key=lambda v: v.support, reverse=True):
        combos = [(v,)]
        for _score, _key, old in sorted(heap):
            combo = tuple(sorted((v,) + old, key=Var.key))
            if valid(combo):
                combos.append(combo)
        if tally is not None:
            tally["rounds"] = tally.get("rounds", 0) + 1
            tally["candidates"] = tally.get("candidates", 0) + len(combos)
        haps = [ref_hap] + [haplotype(contig, start, end, c, rlen)
                            for c in combos]
        ll = read_logliks(haps, reads, rows, win_lo, win_hi, device)
        with np.errstate(over="ignore"):
            per_read = np.log(0.5 * (np.exp(ll[:1]) + np.exp(ll[1:])))
        if samples:
            scores = np.max(np.stack([per_read[:, m].sum(axis=1)
                                      for m in samples]), axis=0)
        else:
            scores = np.full(len(combos), -1e20)
        for combo, sc in zip(combos, scores):
            item = (float(sc), tuple(x.key() for x in combo), combo)
            if len(heap) < keep:
                heapq.heappush(heap, item)
            else:
                heapq.heappushpop(heap, item)
    return [tuple(index[id(x)] for x in combo)
            for _s, _k, combo in sorted(heap, reverse=True)][:keep]
