"""Read QC, trimming and windowed slicing over ReadSet batches.

Vectorised reimplementation of the reference's read-buffer machinery
(Platypus src/cython/cwindow.pyx):

* `check_and_trim_reads` == checkAndTrimRead (cwindow.pyx:332-481): the same
  filter cascade (secondary, low mapq, too-few good-quality bases, unmapped,
  unmapped/distant mate, small insert, duplicate-vs-previous-stream-read) and
  the same in-place quality zeroing (low-quality tails, overlapping mate
  segment, adapter read-through, soft-clipped bases).
* triage into good / bad read sets, where — exactly as in the reference —
  reads failing only the mate-unmapped / mate-distant checks carry **no**
  QC-fail mark and still contribute alignment likelihoods from the bad pile.
* `window_slice` == ReadArray.setWindowPointers (cwindow.pyx:209-239):
  pos-sorted bisection with the longest-read lookback, then skipping reads
  ending at or before the window start.

The SoA layout means the filter cascade is NumPy boolean algebra over the
whole region instead of a per-read C loop — the same work the reference does,
restructured for batch throughput and for feeding device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bam import (
    CIGAR_I,
    CIGAR_M,
    CIGAR_S,
    FLAG_DUP,
    FLAG_MREVERSE,
    FLAG_MUNMAP,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_UNMAP,
    ReadSet,
    empty_read_set,
)

# Filter-counter indices (cwindow.pyx LOW_MAP_QUAL etc).
LOW_MAP_QUAL = 0
LOW_QUAL_BASES = 1
UNMAPPED_READ = 2
MATE_UNMAPPED = 3
MATE_DISTANT = 4
SMALL_INSERT = 5
DUPLICATE = 6

FILTER_NAMES = [
    "low_map_qual",
    "low_qual_bases",
    "unmapped",
    "mate_unmapped",
    "mate_distant",
    "small_insert",
    "duplicate",
]


@dataclass
class QCOptions:
    min_map_qual: int = 20
    min_base_qual: int = 20
    min_good_qual_bases: int = 20
    min_flank: int = 10
    trim_read_flank: int = 0
    trim_overlapping: int = 1
    trim_adapter: int = 1
    trim_soft_clipped: int = 1
    filter_duplicates: int = 1
    filter_reads_with_unmapped_mates: int = 1
    filter_reads_with_distant_mates: int = 1
    filter_read_pairs_with_small_inserts: int = 1


def check_and_trim_reads(reads: ReadSet, opts: QCOptions) -> Tuple[np.ndarray, Dict[str, int]]:
    """Apply the QC cascade to a stream-ordered ReadSet.

    Returns (good_mask, filter_counts); mutates reads.qual in place for the
    trimming steps and sets reads.qc_fail.
    """
    n = len(reads)
    counts = {name: 0 for name in FILTER_NAMES}
    if n == 0:
        return np.zeros(0, bool), counts

    flag = reads.flag
    rlen = reads.rlen.astype(np.int64)

    bad = np.zeros(n, bool)
    qc_fail = np.zeros(n, bool)

    # 1. secondary only.  Supplementary (0x800) reads are NOT dropped: the
    # reference reuses bit 2048 as its internal "compressed" marker and
    # clears it on every read at load (htslibWrapper.pyx:404,
    # htslibWrapper.pxd:245), so a supplementary alignment flows through its
    # QC as an ordinary read.  Verified against the RUNNING reference on the
    # S55 HLA islands (dense repeats are where split/supplementary
    # alignments live — dropping them shifted TC/BRF/GOF and lost a 2-read
    # MNP candidate; docs/REFERENCE_RUN.md).
    sec = (flag & FLAG_SECONDARY) != 0
    qc_fail |= sec
    bad |= sec

    # 2. low mapping quality.
    low_mapq = ~bad & (reads.mapq < opts.min_map_qual)
    counts["low_map_qual"] = int(low_mapq.sum())
    qc_fail |= low_mapq
    bad |= low_mapq

    # 3. too few bases with qual >= min_base_qual.  Every ReadSet producer
    # zero-pads qual beyond rlen (bam.py:653, native batch_fill into zeroed
    # buffers, _concat_read_sets), so for minq >= 1 the padding can't count
    # and the [N, L] valid-mask temporaries are unnecessary.
    if opts.min_base_qual >= 1:
        n_good_bases = (reads.qual >= opts.min_base_qual).sum(axis=1)
    else:
        n_good_bases = ((reads.qual >= opts.min_base_qual) & _valid_mask(reads)).sum(axis=1)
    low_qual = ~bad & (n_good_bases < opts.min_good_qual_bases)
    counts["low_qual_bases"] = int(low_qual.sum())
    qc_fail |= low_qual
    bad |= low_qual

    # 4. unmapped.
    unmapped = ~bad & ((flag & FLAG_UNMAP) != 0)
    counts["unmapped"] = int(unmapped.sum())
    qc_fail |= unmapped
    bad |= unmapped

    paired = (flag & FLAG_PAIRED) != 0

    # 5. mate unmapped — bad but NOT qc-failed (cwindow.pyx:367-371).
    if opts.filter_reads_with_unmapped_mates:
        mate_unmapped = ~bad & paired & ((flag & FLAG_MUNMAP) != 0)
        counts["mate_unmapped"] = int(mate_unmapped.sum())
        bad |= mate_unmapped

    # 6. mate distant / not proper pair — bad but NOT qc-failed.
    if opts.filter_reads_with_distant_mates:
        distant = (
            ~bad
            & paired
            & ((reads.chrom_id != reads.mate_chrom_id) | ((flag & FLAG_PROPER_PAIR) == 0))
        )
        counts["mate_distant"] = int(distant.sum())
        bad |= distant

    # 7. small insert (adapter contamination).
    if opts.filter_read_pairs_with_small_inserts:
        small = (
            ~bad
            & paired
            & (reads.insert_size != 0)
            & (np.abs(reads.insert_size) < rlen)
        )
        counts["small_insert"] = int(small.sum())
        qc_fail |= small
        bad |= small

    # 8. duplicates: the flag, plus the coordinate check against the previous
    # read in stream order (cwindow.pyx:389-410).
    if opts.filter_duplicates:
        dup = ~bad & ((flag & FLAG_DUP) != 0)
        if n > 1:
            same_pos = np.zeros(n, bool)
            same_pos[1:] = (reads.pos[1:] == reads.pos[:-1]) & (reads.rlen[1:] == reads.rlen[:-1])
            same_mate = np.zeros(n, bool)
            same_mate[1:] = reads.mate_pos[1:] == reads.mate_pos[:-1]
            coord_dup = same_pos & np.where(paired, same_mate, True)
            dup |= ~bad & coord_dup
        counts["duplicate"] = int(dup.sum())
        qc_fail |= dup
        bad |= dup

    reads.qc_fail[:] = qc_fail

    # ---- trimming (good reads only) --------------------------------------
    good_idx = np.nonzero(~bad)[0]
    _trim_good_reads(reads, good_idx, opts)

    return ~bad, counts


def trim_counts(reads: ReadSet, good: np.ndarray, opts: QCOptions) -> Dict[str, int]:
    """How many good reads meet the overlapping-mate and the adapter
    read-through trim's condition (_trim_good_reads), from the same fields:
    {"overlap": n, "adapter": n}."""
    flag = reads.flag
    rlen = reads.rlen.astype(np.int64)
    abs_ins = np.abs(reads.insert_size.astype(np.int64))
    paired = good & ((flag & FLAG_PAIRED) != 0) & (abs_ins > 0)
    overlap = (paired & ((flag & FLAG_REVERSE) == 0)
               & ((flag & FLAG_MREVERSE) != 0) & (abs_ins < 2 * rlen))
    adapter = paired & (abs_ins < rlen)
    return {"overlap": int(overlap.sum()) if opts.trim_overlapping else 0,
            "adapter": int(adapter.sum()) if opts.trim_adapter else 0}


def _valid_mask(reads: ReadSet) -> np.ndarray:
    L = reads.seq.shape[1]
    return np.arange(L)[None, :] < reads.rlen[:, None]


def _trim_good_reads(reads: ReadSet, idx: np.ndarray, opts: QCOptions) -> None:
    """In-place quality zeroing (cwindow.pyx:416-479).

    Uses the native C++ trimmer when built; this Python loop is the
    fallback and semantics oracle."""
    from ..native import native_trim_reads

    good_mask = np.zeros(len(reads), bool)
    good_mask[idx] = True
    if native_trim_reads(reads, good_mask, opts.trim_read_flank,
                         opts.trim_overlapping, opts.trim_adapter,
                         opts.trim_soft_clipped):
        return
    qual = reads.qual
    for i in idx:
        rl = int(reads.rlen[i])
        fl = int(reads.flag[i])
        q = qual[i]
        reverse = bool(fl & FLAG_REVERSE)

        # Low-quality tail + fixed flank trim.
        if not reverse:
            for k in range(1, rl + 1):
                if k < opts.trim_read_flank or q[rl - k] < 5:
                    q[rl - k] = 0
                else:
                    break
        else:
            for k in range(rl):
                if k < opts.trim_read_flank or q[k] < 5:
                    q[k] = 0
                else:
                    break

        ins = int(reads.insert_size[i])
        abs_ins = abs(ins)
        paired = bool(fl & FLAG_PAIRED)

        # Overlapping-mate trim on the forward read of short fragments.
        if (
            opts.trim_overlapping
            and paired
            and abs_ins > 0
            and not reverse
            and (fl & FLAG_MREVERSE)
            and abs_ins < 2 * rl
        ):
            n_zero = min(rl, 2 * rl - ins + 1)
            if n_zero > 0:
                q[rl - n_zero : rl] = 0

        # Adapter read-through trim.  The reference zeroes the same index
        # set [absIns, rlen) on both strands through two differently-shaped
        # loops (cwindow.pyx:445-452); one statement covers both.
        if opts.trim_adapter and paired and 0 < abs_ins < rl:
            q[abs_ins:rl] = 0

        # Soft-clipped bases -> qual 0.
        if opts.trim_soft_clipped:
            pos_in_read = 0
            for op, ln in reads.cigar_ops(i):
                if op == CIGAR_M or op == CIGAR_I:
                    pos_in_read += int(ln)
                elif op == CIGAR_S:
                    q[pos_in_read : pos_in_read + int(ln)] = 0
                    pos_in_read += int(ln)


class SampleReadBuffer:
    """Per-sample good/bad/broken-mate read piles with window slicing —
    the TPU-era bamReadBuffer (cwindow.pyx:485-766)."""

    def __init__(
        self,
        sample: str,
        good: ReadSet,
        bad: ReadSet,
        broken: Optional[ReadSet] = None,
        filter_counts: Optional[Dict[str, int]] = None,
        presorted: bool = False,
        trimmed: Optional[Dict[str, int]] = None,
    ):
        self.sample = sample
        self.good = good
        self.bad = bad
        self.broken = broken if broken is not None else empty_read_set()
        self.filter_counts = filter_counts or {}
        self.trimmed = trimmed or {}
        # Sort by adjusted pos (stable keeps stream order for ties).
        # presorted=True: good/bad already arrive pos-sorted (the fused
        # split+sort gather in build_sample_buffer) — skip the re-argsort.
        if not presorted:
            self.good = _sort_by(self.good, self.good.pos)
            self.bad = _sort_by(self.bad, self.bad.pos)
        self.broken = _sort_by(self.broken, self.broken.mate_pos)
        self._longest_good = int((self.good.end - self.good.pos).max()) if len(self.good) else 0
        self._longest_bad = int((self.bad.end - self.bad.pos).max()) if len(self.bad) else 0
        self._longest_broken = (
            int((self.broken.end - self.broken.pos).max()) if len(self.broken) else 0
        )
        self._slice_cache: Dict[tuple, slice] = {}

    # -- slicing -----------------------------------------------------------
    # Each window's slice is requested several times per pile (count gate,
    # read gather, assembly tiles), so results are memoized; the pos/end
    # arrays are immutable after buffer construction.
    def window_slice(self, start: int, end: int) -> slice:
        key = ("g", start, end)
        s = self._slice_cache.get(key)
        if s is None:
            s = _window_slice(self.good, self._longest_good, start, end)
            self._slice_cache[key] = s
        return s

    def bad_window_slice(self, start: int, end: int) -> slice:
        key = ("b", start, end)
        s = self._slice_cache.get(key)
        if s is None:
            s = _window_slice(self.bad, self._longest_bad, start, end)
            self._slice_cache[key] = s
        return s

    def broken_window_slice(self, start: int, end: int) -> slice:
        if len(self.broken) == 0:
            return slice(0, 0)
        key = ("k", start, end)
        s = self._slice_cache.get(key)
        if s is None:
            first = max(1, start - self._longest_broken)
            lo, hi = np.searchsorted(self.broken.mate_pos, (first, end), side="left")
            s = slice(int(lo), max(int(lo), int(hi)))
            self._slice_cache[key] = s
        return s

    def precompute_window_slices(self, bounds) -> None:
        """Bulk-fill the slice memo for many (start, end) windows: two
        vectorized searchsorted probes per pile instead of two numpy calls
        per (window, pile)."""
        if not bounds:
            return
        starts = np.fromiter((b[0] for b in bounds), np.int64, len(bounds))
        ends = np.fromiter((b[1] for b in bounds), np.int64, len(bounds))
        for tag, rs, longest in (("g", self.good, self._longest_good),
                                 ("b", self.bad, self._longest_bad)):
            cache = self._slice_cache
            n = len(rs)
            if n == 0:
                empty = slice(0, 0)
                for st, en in bounds:
                    cache[(tag, int(st), int(en))] = empty
                continue
            firsts = np.maximum(1, starts - longest)
            los = np.searchsorted(rs.pos, firsts, side="left")
            his = np.minimum(np.searchsorted(rs.pos, ends, side="left"), n)
            end_arr = rs.end
            for k in range(len(bounds)):
                lo = int(los[k])
                st = int(starts[k])
                while lo < n and end_arr[lo] <= st:
                    lo += 1
                cache[(tag, st, int(ends[k]))] = slice(lo, max(lo, int(his[k])))
        if len(self.broken):
            firsts = np.maximum(1, starts - self._longest_broken)
            los = np.searchsorted(self.broken.mate_pos, firsts, side="left")
            his = np.searchsorted(self.broken.mate_pos, ends, side="left")
            for k in range(len(bounds)):
                lo = int(los[k])
                self._slice_cache[("k", int(starts[k]), int(ends[k]))] = (
                    slice(lo, max(lo, int(his[k]))))

    def count_reads_covering_region(self, start: int, end: int) -> int:
        s = self.window_slice(start, end)
        return s.stop - s.start

    def count_reads_covering_positions(self, positions: np.ndarray) -> np.ndarray:
        """count_reads_covering_region(p, p+1) for many positions at once —
        two vectorised searchsorted calls instead of two per variant."""
        rs = self.good
        n = len(rs)
        out = np.zeros(len(positions), np.int64)
        if n == 0 or len(positions) == 0:
            return out
        positions = positions.astype(np.int64)
        firsts = np.maximum(1, positions - self._longest_good)
        # tolist() once: per-element indexing of numpy arrays boxes an
        # int64 scalar per access and dominates this loop (2.6x measured).
        los = np.searchsorted(rs.pos, firsts, side="left").tolist()
        his = np.minimum(np.searchsorted(rs.pos, positions + 1, side="left"),
                         n).tolist()
        ends = rs.end.tolist()
        ps = positions.tolist()
        res = [0] * len(ps)
        for i in range(len(ps)):
            lo = los[i]
            s = ps[i]
            while lo < n and ends[lo] <= s:
                lo += 1
            d = his[i] - lo
            if d > 0:
                res[i] = d
        out[:] = res
        return out

    def count_alignment_gaps(self, start: int, end: int) -> int:
        """Indel+clip ops seen by the mapper in good+bad reads in the window
        (cwindow.pyx:597-623: counts ops with code 1..4)."""
        total = 0
        for rs, sl in ((self.good, self.window_slice(start, end)),
                       (self.bad, self.bad_window_slice(start, end))):
            for i in range(sl.start, sl.stop):
                ops = rs.cigar_ops(i)
                total += int(((ops[:, 0] >= 1) & (ops[:, 0] <= 4)).sum())
        return total

    def count_improper_pairs(self, start: int, end: int) -> int:
        total = 0
        for rs, sl in ((self.good, self.window_slice(start, end)),
                       (self.bad, self.bad_window_slice(start, end))):
            fl = rs.flag[sl.start : sl.stop]
            total += int(((fl & FLAG_PROPER_PAIR) == 0).sum())
        return total


def _sort_by(rs: ReadSet, key: np.ndarray) -> ReadSet:
    if len(rs) <= 1:
        return rs
    order = np.argsort(key, kind="stable")
    if np.all(order == np.arange(len(rs))):
        return rs
    return rs.take(order)


def _window_slice(rs: ReadSet, longest: int, start: int, end: int) -> slice:
    if len(rs) == 0:
        return slice(0, 0)
    first = max(1, start - longest)
    lo, hi = np.searchsorted(rs.pos, (first, end), side="left")
    lo, hi = int(lo), int(hi)
    while lo < len(rs) and rs.end[lo] <= start:
        lo += 1
    hi = min(hi, len(rs))
    return slice(lo, max(lo, hi))


def build_sample_buffer(sample: str, stream: ReadSet, opts: QCOptions,
                        broken: Optional[ReadSet] = None) -> SampleReadBuffer:
    """QC a stream-ordered ReadSet and triage it into a SampleReadBuffer."""
    good_mask, counts = check_and_trim_reads(stream, opts)
    trimmed = trim_counts(stream, good_mask, opts)
    # Fused split+sort: gather each pile once, already in adjusted-pos order
    # (a stable argsort of the subset equals the subset of the stable overall
    # order, so this is row-identical to split-then-sort — but reads whose
    # leading soft clips de-sorted `pos` no longer pay a second full gather).
    good_idx = np.nonzero(good_mask)[0]
    bad_idx = np.nonzero(~good_mask)[0]
    good = stream.take(good_idx[np.argsort(stream.pos[good_idx], kind="stable")])
    bad = stream.take(bad_idx[np.argsort(stream.pos[bad_idx], kind="stable")])
    return SampleReadBuffer(sample, good, bad, broken, counts, presorted=True,
                            trimmed=trimmed)
