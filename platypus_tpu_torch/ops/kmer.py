"""k-mer anchor mapping: decide where each read aligns on each haplotype.

Reimplements the reference's hash/vote machinery
(Platypus src/cython/calign.pyx:25-272):

* 7-mer rolling hash over the {A:1,C:3,G:2,T:0}&3 encoding (N collides with
  G, exactly as upstream);
* a read votes, for every one of its first (len-7) k-mers, for each
  haplotype offset where that k-mer occurs; every offset achieving the
  maximum vote count — subject to the band-fit constraint
  offset + readLen + 15 < hapLen — is an alignment anchor, plus the BAM
  mapping position clamped into the haplotype;
* each anchor yields a haplotype *segment start* max(0, offset - 8), the
  hap slice handed to the banded aligner; the final score for the
  (read, hap) pair is the min over its anchor segments.

Unlike the reference's per-(read,hap) C loops, voting here is vectorised
per haplotype across all reads at once (flat hash join via searchsorted +
segmented max), which is the layout the batched device kernel wants.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

HASH_NUCS = 7
HASH_SIZE = 4 ** HASH_NUCS

# byte & 7 -> code; code 7 -> 2; then & 3 (calign.pyx:61-76).
_CODE_LUT = np.zeros(256, dtype=np.int64)
for _b in range(256):
    _c = _b & 7
    if _c == 7:
        _c = 2
    _CODE_LUT[_b] = _c & 3

_POWERS = (4 ** np.arange(HASH_NUCS - 1, -1, -1)).astype(np.int64)


def kmer_hashes(seq: np.ndarray) -> np.ndarray:
    """Hashes of all 7-mers of a 1-D uint8 sequence ([len-6] entries)."""
    codes = _CODE_LUT[seq]
    n = len(seq) - HASH_NUCS + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(codes, HASH_NUCS)
    return windows @ _POWERS


class HaplotypeKmerIndex:
    """Sorted (hash -> positions) index over one haplotype sequence."""

    def __init__(self, hap_seq: bytes):
        self.hap_len = len(hap_seq)
        arr = np.frombuffer(hap_seq, dtype=np.uint8)
        hashes = kmer_hashes(arr)
        # The reference indexes k-mer start positions 0 .. hapLen-8
        # (calign.pyx:109: range(sequenceLength - hash_nucs)).
        hashes = hashes[: max(0, self.hap_len - HASH_NUCS)]
        order = np.argsort(hashes, kind="stable")
        self.sorted_hashes = hashes[order]
        self.sorted_pos = order.astype(np.int64)


def read_kmer_table(read_seq: np.ndarray, read_len: np.ndarray):
    """Flat (read row, k-mer offset, hash) table for a pile of reads —
    computed once per window and shared by every haplotype's vote."""
    R, L = read_seq.shape
    codes = _CODE_LUT[read_seq]
    if L >= HASH_NUCS:
        windows = np.lib.stride_tricks.sliding_window_view(codes, HASH_NUCS, axis=1)
        all_hashes = windows @ _POWERS            # [R, L-6]
    else:
        all_hashes = np.zeros((R, 0), dtype=np.int64)
    K = all_hashes.shape[1]
    # k-mers used for mapping: indices 0 .. read_len-8 (count read_len-7).
    kmer_valid = np.arange(K)[None, :] < (read_len.astype(np.int64) - HASH_NUCS)[:, None]
    rr, kk = np.nonzero(kmer_valid)
    return rr, kk, all_hashes[rr, kk]


def candidate_segments(
    index: HaplotypeKmerIndex,
    read_seq: np.ndarray,        # [R, L] uint8 padded
    read_len: np.ndarray,        # [R]
    read_start: np.ndarray,      # [R] genomic pos
    hap_start: int,              # genomic pos of hap sequence start
    kmer_table=None,             # optional precomputed read_kmer_table(...)
) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor segment starts for every read against one haplotype.

    Returns (pair_read_idx [P], seg_start [P]): each row is one alignment
    to run; reads with len < 7 produce no rows (their score is 0 by
    construction, calign.pyx:179-180).
    """
    R, L = read_seq.shape
    hap_len = index.hap_len
    read_len = read_len.astype(np.int64)

    if kmer_table is None:
        kmer_table = read_kmer_table(read_seq, read_len)
    rr, kk, flat_hash = kmer_table

    lo = np.searchsorted(index.sorted_hashes, flat_hash, side="left")
    hi = np.searchsorted(index.sorted_hashes, flat_hash, side="right")
    counts = hi - lo
    total = int(counts.sum())

    pair_reads: List[np.ndarray] = []
    pair_segs: List[np.ndarray] = []

    span = hap_len + L + 1  # anchor + L is in [0, span)

    if total > 0:
        # Expand [lo, hi) ranges into flat hit indices.
        reps = counts
        hit_off = np.repeat(lo, reps) + (
            np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
        )
        hit_read = np.repeat(rr, reps)
        hit_kmer = np.repeat(kk, reps)
        hit_anchor = index.sorted_pos[hit_off] - hit_kmer  # indexOfReadIntoHap

        keys = hit_read * span + (hit_anchor + L)
        uniq, ucounts = np.unique(keys, return_counts=True)
        u_read = uniq // span
        u_anchor = (uniq % span) - L

        # Per-read max vote, then the tied anchors in ascending order.
        boundaries = np.nonzero(np.diff(u_read, prepend=-1))[0]
        max_per_group = np.maximum.reduceat(ucounts, boundaries)
        group_id = np.cumsum(np.isin(np.arange(len(u_read)), boundaries)) - 1
        is_max = ucounts == max_per_group[group_id]

        # Band-fit constraint (calign.pyx:228).
        fits = (u_anchor >= -read_len[u_read]) & (u_anchor + read_len[u_read] + 15 < hap_len)
        sel = is_max & fits
        if sel.any():
            pair_reads.append(u_read[sel])
            pair_segs.append(np.maximum(0, u_anchor[sel] - 8))

    # --- BAM-position anchor (always tried; calign.pyx:249-267) ---------
    eligible = read_len >= HASH_NUCS
    bam_anchor = np.minimum(read_start - hap_start, hap_len - read_len - 15)
    bam_seg = np.maximum(0, bam_anchor - 8)
    idx = np.nonzero(eligible)[0]
    pair_reads.append(idx)
    pair_segs.append(bam_seg[idx])

    pr = np.concatenate(pair_reads)
    ps = np.concatenate(pair_segs)

    # Dedupe identical (read, segment) rows — identical alignments.
    key = pr * (hap_len + 2 * L + 32) + ps
    _, first = np.unique(key, return_index=True)
    first.sort()
    return pr[first], ps[first]
