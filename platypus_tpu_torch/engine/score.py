"""Window scoring: build the (haplotype x read) log-likelihood matrix.

Instead of aligning read-by-read (the reference's per-(hap, individual)
alignment cache loop, chaplotype.pyx:306-377 + calign.pyx:170-272), the
port

1. collects every read in the window (good + bad + broken piles of every
   sample, in that order -- the reference's likelihood array layout),
2. computes, per haplotype, the k-mer anchor segments for all reads at once
   (the native voter, or ops/kmer.py),
3. gathers the haplotype segments of every (read, hap, anchor) pair and
   runs the banded DP on them,
4. min-reduces anchors and converts scores to log-likelihoods.

Scoring is two-phase: `build_alignment_request` does the host-side pair
construction per window, and `dispatch_alignment_requests` aligns MANY
windows' pairs at once, scattering scores back per window when the
PendingAlignments it returns is finalized.  Where the pairs align depends
on the device given:

* a torch device: per read-length group the deduplicated haplotype / read
  matrices upload once, and each chunk of pairs runs gather/pad and the
  banded DP on the device -- K1 (ops/align_cuda.band_align_padded) for
  plain scores, K2 (its traceback mode) for --calculateFlankScore
  requests, whose per-pair backtrace and flank penalty then run on the
  host.  Results stay on the device until copy_to_host() fetches them;
* None, the host path of a pool's host worker: the native C++ 8-lane
  wavefront (bit-identical scores) for plain requests and the scalar
  traceback (_scalar_flank_scores) for flank requests.  torch is never
  imported on this path.

`score_reads_vs_haplotypes` is the single-window wrapper (used by the beam
search and the HLA path).

Reads that are QC-failed or overlap the window haplotype span by < 7 bases
contribute log-likelihood 0 (probability 1) without being aligned; broken
mates skip the overlap test (chaplotype.pyx:341-373).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..io.readbuffer import SampleReadBuffer
from ..models.haplotype import Haplotype
from ..native import native_kmer_segments
from ..ops.align_core import (N_LANES, band_align_traceback,
                              calculate_flank_score,
                              traceback_from_backpointers,
                              unpack_backpointers)
from ..ops.kmer import HASH_NUCS, candidate_segments, read_kmer_table
from ..ops.likelihood import scores_to_logliks
from ..utils.backend import device_stage, fetch
from ..utils.observability import GLOBAL_METRICS as metrics

_N_CHAR = ord("N")

# Fixed lane widths of a K1 launch: a chunk of pairs is padded to the
# smallest that holds it.
LANE_BUCKETS = (2048, 16384)

# Bound on the int32 label block [n_steps*8, B] of one K2 launch; a read
# bucket whose largest lane chunk would exceed it is cut into smaller chunks.
FLANK_BP_BYTES = 256 << 20


def _native_align_threads() -> int:
    budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) or (os.cpu_count() or 1)
    return min(4, budget)

@dataclass
class WindowReads:
    """All reads of a window, flattened across samples and piles."""

    seq: np.ndarray          # [R, L] uint8
    qual: np.ndarray         # [R, L] uint8 (post-trimming)
    rlen: np.ndarray         # [R] int32
    pos: np.ndarray          # [R] int64
    end: np.ndarray          # [R] int64
    mapq: np.ndarray         # [R] int32
    strand_reverse: np.ndarray  # [R] bool
    qc_fail: np.ndarray      # [R] bool
    is_broken: np.ndarray    # [R] bool
    sample_idx: np.ndarray   # [R] int32
    is_good: np.ndarray      # [R] bool (good pile, i.e. counts for nReads)
    cigar_refs: List[Tuple[object, int]]  # (ReadSet, row) for INFO re-walks

    def __len__(self) -> int:
        return int(self.rlen.shape[0])

    _single_m: Optional[np.ndarray] = None
    # Region-precomputed non-single-M cigar CSR for the native INFO pass:
    # (nsm_idx [R] int32 into the REGION-level tables, nsm_flat, nsm_off).
    nsm_ctx: Optional[tuple] = None

    def single_m(self) -> np.ndarray:
        """[R] bool: cigar is exactly one M/=/X op — the common case the
        INFO re-walk vectorises (computed once per window, lazily)."""
        if self._single_m is None:
            if isinstance(self.cigar_refs, CigarRefs):
                self._single_m = self.cigar_refs.single_m_mask()
            else:
                out = np.zeros(len(self), bool)
                for r, (rs, row) in enumerate(self.cigar_refs):
                    off = rs.cigar_off
                    lo = int(off[row])
                    if int(off[row + 1]) - lo == 1:
                        out[r] = (int(rs.cigar_flat[lo]) & 0xF) in (0, 7, 8)
                self._single_m = out
        return self._single_m


class CigarRefs:
    """Lazy (ReadSet, row) sequence over block segments.

    gather_window_reads copies read payloads in contiguous block slices;
    materialising a (ReadSet, row) tuple per read for the INFO re-walks
    costs more than the block copies themselves, so this keeps only the
    (readset, start) per segment and resolves rows on demand."""

    __slots__ = ("readsets", "starts", "offsets")

    def __init__(self, segs):
        # segs: list of (ReadSet, start, stop) with stop > start
        self.readsets = [rs for rs, _, _ in segs]
        self.starts = [s for _, s, _ in segs]
        lens = np.array([e - s for _, s, e in segs], np.int64)
        self.offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, r: int):
        seg = int(np.searchsorted(self.offsets, r, side="right")) - 1
        return self.readsets[seg], self.starts[seg] + (r - int(self.offsets[seg]))

    def single_m_mask(self) -> np.ndarray:
        out = np.zeros(len(self), bool)
        for seg, rs in enumerate(self.readsets):
            o = int(self.offsets[seg])
            n = int(self.offsets[seg + 1]) - o
            s = self.starts[seg]
            off = rs.cigar_off[s : s + n + 1]
            # Zero-cigar rows (unmapped mates in the bad pile) can sit at
            # the END of the flat array, where their start offset equals
            # len(cigar_flat) — clip the gather; the one-op length check
            # below already masks those rows to False.
            if len(rs.cigar_flat) == 0:
                continue
            first_op = rs.cigar_flat[
                np.minimum(off[:-1], len(rs.cigar_flat) - 1)] & 0xF
            out[o : o + n] = ((off[1:] - off[:-1]) == 1) & (
                (first_op == 0) | (first_op == 7) | (first_op == 8))
        return out


class RegionReadMatrix:
    """Region-level concatenation of every buffer's piles in (sample;
    good, bad, broken) order, with per-read tails pre-zeroed.

    A window's reads are then 3·I contiguous row ranges, so the per-window
    gather is ONE fancy-index per field instead of ~10 numpy block copies
    per (sample, pile) — the fixed numpy overhead dominated
    gather_window_reads on cohort runs.  Not used under --compressReads
    (the memory mode must not keep dense region-wide columns)."""

    def __init__(self, buffers: Sequence[SampleReadBuffer]):
        from ..io.bam import FLAG_REVERSE

        self.buffers = buffers
        self.segs = []  # (s_idx, pile_tag, rs, base_row)
        base = 0
        widths = []
        for s_idx, buf in enumerate(buffers):
            for tag, rs in (("good", buf.good), ("bad", buf.bad), ("broken", buf.broken)):
                self.segs.append((s_idx, tag, rs, base))
                base += len(rs)
                if len(rs):
                    widths.append(rs.width)
        N = base
        L = max(widths, default=0)
        self.seq = np.zeros((N, L), np.uint8)
        self.qual = np.zeros((N, L), np.uint8)
        self.rlen = np.zeros(N, np.int32)
        self.pos = np.zeros(N, np.int64)
        self.end = np.zeros(N, np.int64)
        self.mapq = np.zeros(N, np.int32)
        self.rev = np.zeros(N, bool)
        self.qc = np.zeros(N, bool)
        self.broken = np.zeros(N, bool)
        self.good = np.zeros(N, bool)
        self.sample_idx = np.zeros(N, np.int32)
        for s_idx, tag, rs, base in self.segs:
            n = len(rs)
            if n == 0:
                continue
            k = min(L, rs.width)
            sl = slice(base, base + n)
            # ReadSet seq/qual rows are zero beyond each read's rlen by
            # construction (np.zeros buffers at load; trims only lower
            # in-read quals), so no tail masking is needed here.  The
            # compressed path, whose lazy decompression does not share the
            # invariant, never builds a RegionReadMatrix (build() gate).
            self.seq[sl, :k] = rs.seq[:, :k]
            self.qual[sl, :k] = rs.qual[:, :k]
            self.rlen[sl] = rs.rlen
            self.pos[sl] = rs.pos
            self.end[sl] = rs.end
            self.mapq[sl] = rs.mapq
            self.rev[sl] = (rs.flag & FLAG_REVERSE) != 0
            self.qc[sl] = rs.qc_fail
            self.broken[sl] = tag == "broken"
            self.good[sl] = tag == "good"
            self.sample_idx[sl] = s_idx

    @staticmethod
    def build(buffers: Sequence[SampleReadBuffer]) -> Optional["RegionReadMatrix"]:
        for buf in buffers:
            for rs in (buf.good, buf.bad, buf.broken):
                if getattr(rs, "is_compressed", False):
                    return None
        return RegionReadMatrix(buffers)

    _nsm: Optional[tuple] = None

    def _nsm_tables(self):
        """Region-level single-M mask + non-single-M cigar CSR, built once
        (the per-window _window_nsm_csr re-derivation measured as one of
        the largest vcf_output costs).  Window slices gather nsm_idx rows;
        the flat/off tables are shared by every window of the region."""
        if self._nsm is not None:
            return self._nsm
        N = len(self.rlen)
        single_m = np.zeros(N, bool)
        nsm_idx = np.full(N, -1, np.int32)
        flats = []
        lens_parts = []
        n_nsm = 0
        for _s_idx, _tag, rs, base in self.segs:
            n = len(rs)
            if n == 0:
                continue
            off = rs.cigar_off
            flat = rs.cigar_flat
            n_ops = (off[1:] - off[:-1]).astype(np.int64)
            if len(flat):
                first_op = flat[np.minimum(off[:-1], len(flat) - 1)] & 0xF
                sm = (n_ops == 1) & ((first_op == 0) | (first_op == 7)
                                     | (first_op == 8))
            else:
                sm = np.zeros(n, bool)
            single_m[base : base + n] = sm
            rows = np.nonzero(~sm)[0]
            if len(rows):
                nsm_idx[base + rows] = n_nsm + np.arange(len(rows),
                                                         dtype=np.int32)
                n_nsm += len(rows)
                row_lens = n_ops[rows]
                total = int(row_lens.sum())
                if total:
                    # One fancy-index gather of all non-single-M cigar words
                    # (repeat/cumsum expansion of the per-row slices).
                    starts = off[rows].astype(np.int64)
                    idx = np.repeat(starts + row_lens, row_lens)
                    cum = np.arange(total, dtype=np.int64) - np.repeat(
                        np.cumsum(row_lens), row_lens)
                    flats.append(flat[(idx + cum)])
                lens_parts.append(row_lens)
        if n_nsm == 0:
            nsm_flat = np.zeros(1, np.uint32)
            nsm_off = np.zeros(1, np.int64)
        else:
            nsm_flat = np.ascontiguousarray(
                np.concatenate(flats) if flats else np.zeros(0, np.uint32),
                np.uint32)
            all_lens = np.concatenate(lens_parts)
            nsm_off = np.zeros(n_nsm + 1, np.int64)
            np.cumsum(all_lens, out=nsm_off[1:])
        self._nsm = (single_m, nsm_idx, nsm_flat, nsm_off)
        return self._nsm

    def gather(self, window_start: int, window_end: int) -> WindowReads:
        slice_of = {"good": lambda b: b.window_slice(window_start, window_end),
                    "bad": lambda b: b.bad_window_slice(window_start, window_end),
                    "broken": lambda b: b.broken_window_slice(window_start, window_end)}
        live = []
        parts = []
        for s_idx, tag, rs, base in self.segs:
            sl = slice_of[tag](self.buffers[s_idx])
            if sl.stop > sl.start:
                live.append((rs, sl))
                parts.append((base + sl.start, base + sl.stop))
        single_m, nsm_idx, nsm_flat, nsm_off = self._nsm_tables()
        if not parts:
            rows = np.zeros(0, np.int64)
        elif len(parts) == 1:
            # Contiguous row range (the dominant single-sample case):
            # basic-slice copies skip the fancy-index machinery.
            lo, hi = parts[0]
            rlen = self.rlen[lo:hi].copy()
            L = int(rlen.max()) if len(rlen) else 0
            seq = np.ascontiguousarray(self.seq[lo:hi, :L])
            qual = np.ascontiguousarray(self.qual[lo:hi, :L])
            cigar_refs = CigarRefs([(rs, sl.start, sl.stop)
                                    for rs, sl in live])
            out = WindowReads(seq, qual, rlen,
                              self.pos[lo:hi].copy(), self.end[lo:hi].copy(),
                              self.mapq[lo:hi].copy(), self.rev[lo:hi].copy(),
                              self.qc[lo:hi].copy(),
                              self.broken[lo:hi].copy(),
                              self.sample_idx[lo:hi].copy(),
                              self.good[lo:hi].copy(), cigar_refs)
            out._single_m = single_m[lo:hi].copy()
            out.nsm_ctx = (np.ascontiguousarray(nsm_idx[lo:hi]),
                           nsm_flat, nsm_off)
            return out
        else:
            rows = np.concatenate([np.arange(lo, hi) for lo, hi in parts])
        rlen = self.rlen[rows]
        L = int(rlen.max()) if len(rlen) else 0
        seq = self.seq[:, :L].take(rows, axis=0)
        qual = self.qual[:, :L].take(rows, axis=0)
        cigar_refs = CigarRefs([(rs, sl.start, sl.stop) for rs, sl in live])
        out = WindowReads(seq, qual, rlen, self.pos[rows], self.end[rows],
                          self.mapq[rows], self.rev[rows], self.qc[rows],
                          self.broken[rows], self.sample_idx[rows],
                          self.good[rows], cigar_refs)
        out._single_m = single_m[rows]
        out.nsm_ctx = (np.ascontiguousarray(nsm_idx[rows]), nsm_flat, nsm_off)
        return out


def gather_window_reads(
    buffers: Sequence[SampleReadBuffer], window_start: int, window_end: int
) -> WindowReads:
    """Collect good+bad+broken reads per sample for a window, in the
    reference's array order (good, bad, broken per individual)."""
    from ..io.bam import FLAG_REVERSE

    # Window slices are contiguous ranges of each pile's arrays, so the
    # gather is block copies, not per-read assignments.
    segs = []
    for s_idx, buf in enumerate(buffers):
        for pile, rs, sl in (
            ("good", buf.good, buf.window_slice(window_start, window_end)),
            ("bad", buf.bad, buf.bad_window_slice(window_start, window_end)),
            ("broken", buf.broken, buf.broken_window_slice(window_start, window_end)),
        ):
            if sl.stop > sl.start:
                segs.append((s_idx, pile, rs, sl))

    R = sum(sl.stop - sl.start for _, _, _, sl in segs)
    L = max((int(rs.rlen[sl.start : sl.stop].max()) for _, _, rs, sl in segs),
            default=0)
    seq = np.zeros((R, L), np.uint8)
    qual = np.zeros((R, L), np.uint8)
    rlen = np.zeros(R, np.int32)
    pos = np.zeros(R, np.int64)
    end = np.zeros(R, np.int64)
    mapq = np.zeros(R, np.int32)
    rev = np.zeros(R, bool)
    qc = np.zeros(R, bool)
    broken = np.zeros(R, bool)
    sample_idx = np.zeros(R, np.int32)
    good = np.zeros(R, bool)
    col = np.arange(L, dtype=np.int32)
    r = 0
    for s_idx, pile, rs, sl in segs:
        n = sl.stop - sl.start
        k = min(L, rs.width)
        block_rlen = rs.rlen[sl.start : sl.stop]
        # seq_qual_rows lazily decompresses under --compressReads.
        block_seq, block_qual = rs.seq_qual_rows(sl)
        seq[r : r + n, :k] = block_seq[:, :k]
        qual[r : r + n, :k] = block_qual[:, :k]
        # Zero any payload beyond each read's length (the per-read copy
        # loop never brought it over).
        tail = col[None, :] >= block_rlen[:, None]
        seq[r : r + n][tail] = 0
        qual[r : r + n][tail] = 0
        rlen[r : r + n] = block_rlen
        pos[r : r + n] = rs.pos[sl.start : sl.stop]
        end[r : r + n] = rs.end[sl.start : sl.stop]
        mapq[r : r + n] = rs.mapq[sl.start : sl.stop]
        rev[r : r + n] = (rs.flag[sl.start : sl.stop] & FLAG_REVERSE) != 0
        qc[r : r + n] = rs.qc_fail[sl.start : sl.stop]
        broken[r : r + n] = pile == "broken"
        good[r : r + n] = pile == "good"
        sample_idx[r : r + n] = s_idx
        r += n
    cigar_refs = CigarRefs([(rs, sl.start, sl.stop) for _, _, rs, sl in segs])
    return WindowReads(seq, qual, rlen, pos, end, mapq, rev, qc, broken,
                       sample_idx, good, cigar_refs)


def _aligned_mask(reads: WindowReads, hap_start: int, hap_end: int) -> np.ndarray:
    """Which reads get a real alignment (others contribute loglik 0)."""
    overlap = np.minimum(reads.end, hap_end) - np.maximum(reads.pos, hap_start)
    overlap = np.where(overlap > 0, overlap, -1)
    ok = (~reads.qc_fail) & ((overlap >= HASH_NUCS) | reads.is_broken)
    return ok


def _l2_bucket(n: int) -> int:
    """Canonical padded read length (multiple of 32) to bound the number of
    compiled kernel shapes."""
    return max(32, -(-n // 32) * 32)


def _geom_bucket(n: int, base: int) -> int:
    """Smallest base*{1,1.5}*2^k >= n: geometric row/width buckets keep the
    number of compiled gather shapes logarithmic in problem size while
    capping padding overhead (and hence upload bytes) at 33%."""
    b = base
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


@dataclass
class AlignmentRequest:
    """Host-side pair batch for one window, ready for device alignment."""

    haps: Sequence[Haplotype]
    reads: WindowReads
    use_map_qual_cap: bool
    calculate_flank_score: bool
    align_rows: np.ndarray   # rows of `reads` that get real alignments
    pair_hap: np.ndarray     # [P] hap index
    pair_read: np.ndarray    # [P] index into align_rows
    pair_seg: np.ndarray     # [P] hap segment start
    sub_seq: np.ndarray      # [A, L2] uint8 (L2 = own bucket)
    sub_qual: np.ndarray     # [A, L2] uint8
    sub_len: np.ndarray      # [A]
    hap_matrix: np.ndarray   # [H, hapmax + seg] uint8, 'N'-padded
    go_matrix: np.ndarray    # [H, hapmax + seg] int32
    # Set while pair voting is deferred to the region-batched native call
    # (fill_deferred_pairs); (hap_lens, hap_starts, sub_pos).
    deferred: object = None

    def n_pairs(self) -> int:
        return len(self.pair_hap)


def build_alignment_request(
    haps: Sequence[Haplotype],
    reads: WindowReads,
    use_map_qual_cap: bool = False,
    calculate_flank_score: bool = False,
    defer_pairs: bool = False,
) -> Optional[AlignmentRequest]:
    """Pair construction for one window; None when nothing needs aligning."""
    H = len(haps)
    R = len(reads)
    if R == 0 or H == 0:
        return None
    win_start = haps[0].start_pos
    win_end = haps[0].end_pos
    align_rows = np.nonzero(_aligned_mask(reads, win_start, win_end))[0]
    if len(align_rows) == 0:
        return None

    sub_len = reads.rlen[align_rows]
    L2 = _l2_bucket(int(sub_len.max()))
    L = reads.seq.shape[1]
    if L < L2:
        # Direct alloc+assign: np.pad's generic machinery costs ~80us/call
        # and this runs per window.
        sub_seq = np.zeros((len(align_rows), L2), np.uint8)
        sub_qual = np.zeros((len(align_rows), L2), np.uint8)
        sub_seq[:, :L] = reads.seq[align_rows]
        sub_qual[:, :L] = reads.qual[align_rows]
    else:
        sub_seq = reads.seq[align_rows][:, :L2]
        sub_qual = reads.qual[align_rows][:, :L2]
    sub_pos = reads.pos[align_rows]

    # Pack the haplotype/gap-open matrices first: the native k-mer voter
    # reads the haplotypes straight out of hap_matrix rows (strided entry),
    # so no flat-blob copy or offset table is built per window.
    seg_len = L2 + 15
    hap_len_max = max(h.hap_len for h in haps)
    hap_matrix = np.full((H, hap_len_max + seg_len), _N_CHAR, np.uint8)
    go_matrix = np.zeros((H, hap_len_max + seg_len), np.int32)
    hap_lens = np.empty(H, np.int32)
    hap_starts = np.empty(H, np.int64)
    for h_idx, hap in enumerate(haps):
        hap_matrix[h_idx, : hap.hap_len] = np.frombuffer(hap.sequence, np.uint8)
        go_matrix[h_idx, : hap.hap_len] = hap.gap_open[: hap.hap_len]
        hap_lens[h_idx] = hap.hap_len
        hap_starts[h_idx] = hap.hap_start

    # The C++ voter runs a ~30-read pile in ~10us vs ~0.4ms of fixed numpy
    # overhead per (window, hap); output rows are byte-identical.  The
    # whole-window entry votes every haplotype in ONE native call — or, with
    # defer_pairs, as part of ONE threaded region-level call later
    # (fill_deferred_pairs).
    use_native = native_kmer_segments is not None and native.load() is not None
    if use_native and defer_pairs:
        req = AlignmentRequest(
            haps=haps, reads=reads, use_map_qual_cap=use_map_qual_cap,
            calculate_flank_score=calculate_flank_score,
            align_rows=align_rows, pair_hap=None, pair_read=None,
            pair_seg=None, sub_seq=sub_seq, sub_qual=sub_qual,
            sub_len=sub_len, hap_matrix=hap_matrix, go_matrix=go_matrix,
        )
        req.deferred = (hap_lens, hap_starts, sub_pos)
        return req
    if use_native:
        from ..native import native_kmer_segments_strided

        pr, ps, counts = native_kmer_segments_strided(
            hap_matrix, hap_lens, hap_starts, sub_seq, sub_len, sub_pos)
        ph = np.repeat(np.arange(H, dtype=np.int64), counts)
    else:
        pair_hap: List[np.ndarray] = []
        pair_read: List[np.ndarray] = []
        pair_seg: List[np.ndarray] = []
        kmer_table = read_kmer_table(sub_seq, sub_len)
        for h_idx, hap in enumerate(haps):
            pr, ps = candidate_segments(
                hap.kmer_index, sub_seq, sub_len, sub_pos, hap.hap_start,
                kmer_table=kmer_table,
            )
            pair_hap.append(np.full(len(pr), h_idx, np.int64))
            pair_read.append(pr)
            pair_seg.append(ps)
        ph = np.concatenate(pair_hap)
        pr = np.concatenate(pair_read)
        ps = np.concatenate(pair_seg)

    return AlignmentRequest(
        haps=haps, reads=reads, use_map_qual_cap=use_map_qual_cap,
        calculate_flank_score=calculate_flank_score,
        align_rows=align_rows, pair_hap=ph, pair_read=pr, pair_seg=ps,
        sub_seq=sub_seq, sub_qual=sub_qual, sub_len=sub_len,
        hap_matrix=hap_matrix, go_matrix=go_matrix,
    )


_MAPQ_TERM_TABLE = None


def fill_deferred_pairs(requests) -> None:
    """Resolve every deferred request's pair voting in ONE threaded native
    call (ptpu_kmer_segments_batch; per-window rows identical to the
    strided entry).  No-op for requests without deferred state."""
    live = [r for r in requests
            if r is not None and getattr(r, "deferred", None) is not None]
    if not live:
        return
    from ..native import native_kmer_segments_batch

    entries = [(r.hap_matrix, r.deferred[0], r.deferred[1],
                r.sub_seq, r.sub_len, r.deferred[2]) for r in live]
    results = native_kmer_segments_batch(entries)
    if results is None:
        # Library vanished between build and fill — per-window fallback.
        for r in live:
            hap_lens, hap_starts, sub_pos = r.deferred
            from ..native import native_kmer_segments_strided

            pr, ps, counts = native_kmer_segments_strided(
                r.hap_matrix, hap_lens, hap_starts, r.sub_seq, r.sub_len,
                sub_pos)
            r.pair_hap = np.repeat(
                np.arange(len(r.haps), dtype=np.int64), counts)
            r.pair_read = pr
            r.pair_seg = ps
            r.deferred = None
        return
    for r, (pr, ps, counts) in zip(live, results):
        r.pair_hap = np.repeat(np.arange(len(r.haps), dtype=np.int64), counts)
        r.pair_read = pr
        r.pair_seg = ps
        r.deferred = None


class PendingAlignments:
    """In-flight alignments for a batch of requests.

    `groups` holds, per read-length group, (owner requests, host score
    buffer, device chunks): the K1 chunks as (tensor, pair slice, take),
    none on the host path, whose native scores are already in the buffer.
    `flank_groups` holds the K2 chunks of flank requests as (owner
    requests, [((score, idx, bp), pair slice)]).  copy_to_host() fetches
    every chunk; finalize() then runs the host backtrace and flank penalty
    for the flank pairs and produces the per-request [H, R] float64
    log-likelihood matrices.  The split lets the engine overlap region
    k+1's host work with region k's device pass (the pipeline-parallel
    host/device split of SURVEY section 2.5)."""

    def __init__(self, requests, gapextend: int, nucprior: int):
        self.requests = list(requests)
        self.gapextend = gapextend
        self.nucprior = nucprior
        self.pair_scores: dict = {}
        self.groups: list = []
        self.flank_groups: list = []
        self._flank_host: list = []  # flank_groups after copy_to_host

    def copy_to_host(self) -> None:
        """Copy every K1 chunk's scores into its group's host buffer in one
        device->host transfer, and every K2 chunk's (score, idx, bp) in one
        transfer per chunk; drop the device tensors."""
        pieces = [(out_scores, sl, dev[:take])
                  for _, out_scores, chunks in self.groups
                  for dev, sl, take in chunks]
        for (out_scores, sl, _), host in zip(pieces,
                                             fetch([p[2] for p in pieces])):
            out_scores[sl] = host
        for _, _, chunks in self.groups:
            chunks.clear()
        for owners, chunks in self.flank_groups:
            self._flank_host.append(
                (owners, [(fetch(list(tensors)), sl) for tensors, sl in chunks]))
        self.flank_groups = []

    def backtrace_flank(self) -> None:
        """copy_to_host(), then the host backtrace and flank penalty of
        every flank pair, into pair_scores."""
        self.copy_to_host()
        for owners, chunks in self._flank_host:
            with metrics.timer("flank_backtrace"):
                for req, scores in zip(owners, _flank_scores(
                        owners, chunks, self.gapextend, self.nucprior)):
                    self.pair_scores[id(req)] = scores
        self._flank_host = []

    def finalize(self) -> List[np.ndarray]:
        self.backtrace_flank()
        for owners, out_scores, _chunks in self.groups:
            off = 0
            for req in owners:
                p = req.n_pairs()
                self.pair_scores[id(req)] = out_scores[off : off + p]
                off += p
        self.groups = []

        # Batched native scatter+convert for the common (non-HLA) windows:
        # one threaded call instead of per-window numpy; the per-read mapq
        # term is precomputed with the same numpy elementwise ops the
        # fallback uses, so results are exact (tests pin e2e bytes).
        native_out: dict = {}
        batch = [req for req in self.requests
                 if req is not None and req.n_pairs() > 0
                 and not req.use_map_qual_cap]
        if batch and native.load() is not None:
            from ..ops.likelihood import MLTOT

            global _MAPQ_TERM_TABLE
            if _MAPQ_TERM_TABLE is None:
                # ln(1 - 10^(-q/10)) per mapq value, built with the SAME
                # numpy elementwise ops the fallback applies — ufuncs are
                # value-wise, so table[q] is bitwise what the fallback
                # computes for q.  mapq is a uint8-range field.
                with np.errstate(divide="ignore"):
                    _MAPQ_TERM_TABLE = np.log(
                        1.0 - np.exp(MLTOT * np.arange(256,
                                                       dtype=np.float64)))
            entries = []
            for req in batch:
                term = _MAPQ_TERM_TABLE[req.reads.mapq[req.align_rows]]
                entries.append((self.pair_scores[id(req)], req.pair_hap,
                                req.pair_read, req.sub_len, term,
                                req.align_rows, len(req.haps),
                                len(req.reads)))
            lls = native.native_loglik_batch(entries, HASH_NUCS, MLTOT)
            if lls is not None:
                native_out = {id(req): ll for req, ll in zip(batch, lls)}

        results: List[np.ndarray] = []
        for req in self.requests:
            if req is None:
                results.append(np.zeros((0, 0), np.float64))
                continue
            ll = native_out.get(id(req))
            if ll is not None:
                results.append(ll)
                continue
            results.append(window_loglik_from_pair_scores(
                req, self.pair_scores[id(req)] if req.n_pairs() else None))
        return results


def window_loglik_from_pair_scores(req: "AlignmentRequest",
                                   pair_scores) -> np.ndarray:
    """[H, R] float64 log-likelihood matrix from a request's per-pair
    alignment scores: scatter-min into the (hap, aligned-read) table,
    short-overlap reads score 0, then the f64 phred->ln conversion.  The
    single source of truth for score->loglik — used by the host dispatch
    (PendingAlignments.finalize) and by the mesh path (whose device
    program returns the same sparse pair scores)."""
    H = len(req.haps)
    R = len(req.reads)
    loglik = np.zeros((H, R), np.float64)
    A = len(req.align_rows)
    scores = np.zeros((H, A), np.int64)
    if pair_scores is not None:
        scores[:] = np.iinfo(np.int32).max
        short = req.sub_len < HASH_NUCS
        scores[:, short] = 0
        np.minimum.at(scores, (req.pair_hap, req.pair_read), pair_scores)
    sub_loglik = scores_to_logliks(
        scores, req.reads.mapq[req.align_rows][None, :],
        use_map_qual_cap=req.use_map_qual_cap,
    )
    loglik[:, req.align_rows] = sub_loglik
    return loglik


def _flank_pair_rows(req: AlignmentRequest):
    """Materialise per-pair haplotype-segment / read rows for the
    traceback kernel (host gather; flank windows are rare enough that the
    dedup-upload machinery of the main path isn't worth it)."""
    L2 = req.sub_seq.shape[1]
    seg_len = L2 + 15
    width = req.hap_matrix.shape[1]
    cols = np.minimum(req.pair_seg[:, None] + np.arange(seg_len)[None, :],
                      width - 1)
    hap_rows = req.hap_matrix[req.pair_hap[:, None], cols]
    go_rows = req.go_matrix[req.pair_hap[:, None], cols]
    reads = req.sub_seq[req.pair_read]
    quals = req.sub_qual[req.pair_read]
    rlen = req.sub_len[req.pair_read].astype(np.int32)
    return hap_rows, go_rows, reads, quals, rlen


def _scalar_flank_scores(req: AlignmentRequest, gapextend: int, nucprior: int) -> np.ndarray:
    """Per-pair scores with the flank-penalty correction (scalar host path;
    calign.pyx:232-237 when --calculateFlankScore is on): the host path's
    flank scoring."""
    L2 = req.sub_seq.shape[1]
    out = np.empty(req.n_pairs(), np.int64)
    for k in range(req.n_pairs()):
        h_idx = int(req.pair_hap[k])
        r_idx = int(req.pair_read[k])
        seg = int(req.pair_seg[k])
        hap = req.haps[h_idx]
        rlen = int(req.sub_len[r_idx])
        seg_len = rlen + 15
        hap_bytes = bytes(req.hap_matrix[h_idx, seg : seg + seg_len].tobytes())
        gapopen = req.go_matrix[h_idx, seg : seg + seg_len]
        read = bytes(req.sub_seq[r_idx, :rlen].tobytes())
        quals = req.sub_qual[r_idx, :rlen]
        score, aln1, aln2, firstpos = band_align_traceback(
            hap_bytes, read, quals, gapextend, nucprior, gapopen
        )
        hap_flank = hap.end_buffer_size
        if score > 0 and hap_flank > 0:
            score -= calculate_flank_score(
                hap.hap_len, hap_flank, quals, hap.gap_open, gapextend, nucprior,
                firstpos + seg, aln1, aln2,
            )
        out[k] = score
    return out


def _flank_pair_score(req: AlignmentRequest, rows, k: int, score: int,
                      idx: int, bp_col: np.ndarray, gapextend: int,
                      nucprior: int) -> int:
    """One pair's flank-corrected score (score.py:949-965): backtrace the
    K2 label words, then subtract the penalty inside the flank buffers."""
    sc = int(score)
    hap = req.haps[int(req.pair_hap[k])]
    hap_flank = hap.end_buffer_size
    if sc > 0 and hap_flank > 0:
        hap_rows, _go_rows, reads, quals, rlen = rows
        n = int(rlen[k])
        aln1, aln2, firstpos = traceback_from_backpointers(
            unpack_backpointers(bp_col), int(idx),
            hap_rows[k, : n + 15].tobytes(), reads[k, :n].tobytes())
        sc -= calculate_flank_score(
            hap.hap_len, hap_flank, quals[k][:n], hap.gap_open, gapextend,
            nucprior, firstpos + int(req.pair_seg[k]), aln1, aln2)
    return sc


def _flank_scores(owners, chunks, gapextend: int,
                  nucprior: int) -> List[np.ndarray]:
    """Per owner request, its [P] int64 flank-corrected pair scores from
    the host copies of a group's K2 chunks (pairs in owner order).  The
    backtrace reads each pair's haplotype bytes as _flank_pair_rows makes
    them, column clamp included.  Counts the pairs whose score the flank
    penalty lowered (`flank_pairs_lowered`)."""
    counts = [req.n_pairs() for req in owners]
    owner_of = np.repeat(np.arange(len(owners)), counts)
    first = np.concatenate([[0], np.cumsum(counts)])
    rows = [_flank_pair_rows(req) for req in owners]
    out = [np.empty(n, np.int64) for n in counts]
    lowered = 0
    for (score_h, idx_h, bp_h), sl in chunks:
        for c, g in enumerate(range(sl.start, sl.stop)):
            o = owner_of[g]
            k = g - first[o]
            out[o][k] = _flank_pair_score(owners[o], rows[o], k, score_h[c],
                                          idx_h[c], bp_h[:, c], gapextend,
                                          nucprior)
            lowered += int(out[o][k] < score_h[c])
    metrics.count("flank_pairs_lowered", lowered)
    return out


def _group_matrices(group):
    """Deduplicated matrices of one read-length group (score.py:758-792):
    each window's unique haplotypes and reads are stacked ONCE; row counts
    and hap width are bucketed exactly as in the JAX package, so both see
    byte-identical matrices.  Returns ([hap, gap-open, read, qual] uint8
    matrices, and the group's concatenated pair hap / read / segment /
    read-length rows)."""
    L2 = group[0].sub_seq.shape[1]
    H_tot = sum(req.hap_matrix.shape[0] for req in group)
    A_tot = sum(req.sub_seq.shape[0] for req in group)
    L1B = _geom_bucket(max(req.hap_matrix.shape[1] for req in group), 256)
    HB = _geom_bucket(H_tot, 256)
    AB = _geom_bucket(A_tot, 4096)
    hap_mat = np.full((HB, L1B), _N_CHAR, np.uint8)
    go_mat = np.zeros((HB, L1B), np.uint8)   # gap opens are <= 78
    seq_mat = np.zeros((AB, L2), np.uint8)
    qual_mat = np.zeros((AB, L2), np.uint8)
    ph_rows, pr_rows, ps_rows, ln_rows = [], [], [], []
    h_off = a_off = 0
    for req in group:
        h, a = req.hap_matrix.shape[0], req.sub_seq.shape[0]
        hap_mat[h_off : h_off + h, : req.hap_matrix.shape[1]] = req.hap_matrix
        go_mat[h_off : h_off + h, : req.go_matrix.shape[1]] = req.go_matrix
        seq_mat[a_off : a_off + a] = req.sub_seq
        qual_mat[a_off : a_off + a] = req.sub_qual
        ph_rows.append(req.pair_hap + h_off)
        pr_rows.append(req.pair_read + a_off)
        ps_rows.append(req.pair_seg)
        ln_rows.append(req.sub_len[req.pair_read])
        h_off += h
        a_off += a
    pairs = [np.concatenate(rows) for rows in (ph_rows, pr_rows, ps_rows, ln_rows)]
    return (hap_mat, go_mat, seq_mat, qual_mat), pairs


def _pair_index(pairs, sl: slice, lane: int, pad_len: int, device):
    """[4, lane] int32 pair hap / read / segment / read-length rows of a
    chunk on `device`; lanes past the chunk's pairs are pad pairs (hap 0,
    read 0, segment 0, length pad_len)."""
    idx = np.zeros((4, lane), np.int32)
    take = sl.stop - sl.start
    for row, values in enumerate(pairs):
        idx[row, :take] = values[sl]
    idx[3, take:] = pad_len
    import torch

    return torch.from_numpy(idx).to(device)


def _dispatch_native(pending: PendingAlignments, live, gapextend: int,
                     nucprior: int) -> None:
    """The host path of dispatch_alignment_requests: flank requests through
    the scalar traceback, every read-length group through one threaded
    native call over the matrices the device path uploads."""
    by_l2: dict = {}
    for req in live:
        if req.calculate_flank_score:
            pending.pair_scores[id(req)] = _scalar_flank_scores(
                req, gapextend, nucprior)
        else:
            by_l2.setdefault(req.sub_seq.shape[1], []).append(req)
    for group in by_l2.values():
        mats, pairs = _group_matrices(group)
        scores = native.native_band_align_pairs(
            *mats, *pairs, gapextend, nucprior, _native_align_threads())
        if scores is None:
            raise RuntimeError("the host path aligns with the native "
                               "library, which could not be loaded")
        pending.groups.append((group, scores, []))


def dispatch_alignment_requests(
    requests: Sequence[Optional[AlignmentRequest]],
    device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> PendingAlignments:
    """Upload + launch every request's pair alignments on `device` (a
    torch device, or None for the host path) without waiting for the
    results; returns a PendingAlignments to finalize()."""
    pending = PendingAlignments(requests, gapextend, nucprior)
    live = [r for r in requests if r is not None and r.n_pairs() > 0]
    if device is None:
        _dispatch_native(pending, live, gapextend, nucprior)
        return pending
    import torch

    from ..ops.align_cuda import band_align_padded, band_align_traceback_padded
    from ..ops.align_torch import gather_pad

    # Group by (flank mode, read-length bucket); concatenate pair rows
    # across windows.  Each group's matrices upload once; per chunk only
    # four [lane] index vectors ship and the pair rows are gathered on the
    # device.
    by_group: dict = {}
    for req in live:
        key = (bool(req.calculate_flank_score), req.sub_seq.shape[1])
        by_group.setdefault(key, []).append(req)

    for (flank, L2), group in by_group.items():
        mats, pairs = _group_matrices(group)
        mats = [torch.from_numpy(m).to(device) for m in mats]
        total = len(pairs[0])
        chunks = []
        if flank:
            # K2 chunks hold exactly their pairs (no lane padding: the
            # label block is the transfer) and keep the block under
            # FLANK_BP_BYTES.
            lane = max(1, min(LANE_BUCKETS[-1],
                              FLANK_BP_BYTES // ((L2 + 8) * N_LANES * 4)))
            for done in range(0, total, lane):
                sl = slice(done, min(total, done + lane))
                padded = gather_pad(*mats, *_pair_index(
                    pairs, sl, sl.stop - sl.start, 0, device))
                chunks.append((band_align_traceback_padded(
                    *padded, gapextend=gapextend, nucprior=nucprior), sl))
            pending.flank_groups.append((group, chunks))
            continue
        done = 0
        while done < total:
            remaining = total - done
            # Smallest bucket that covers the remainder (or the largest).
            lane = next((b for b in LANE_BUCKETS if remaining <= b),
                        LANE_BUCKETS[-1])
            take = min(remaining, lane)
            sl = slice(done, done + take)
            padded = gather_pad(*mats, *_pair_index(pairs, sl, lane,
                                                    min(8, L2), device))
            dev = band_align_padded(*padded, gapextend=gapextend,
                                    nucprior=nucprior)
            chunks.append((dev, sl, take))
            done += take
        pending.groups.append((group, np.empty(total, np.int64), chunks))

    return pending


def _aligned(requests, device, gapextend: int, nucprior: int,
             what: str) -> PendingAlignments:
    """Dispatch and copy to the host; a failure of the device work raises
    DeviceError, which the window containments let through."""
    with device_stage(device, f"device scoring of {what}"):
        pending = dispatch_alignment_requests(requests, device, gapextend,
                                              nucprior)
        pending.copy_to_host()
    return pending


def run_alignment_requests(
    requests: Sequence[Optional[AlignmentRequest]],
    device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> List[np.ndarray]:
    """One [H, R] log-likelihood matrix per request (a zeros matrix for a
    None request).  A failure of the device work raises DeviceError."""
    return _aligned(requests, device, gapextend, nucprior,
                    f"{len(requests)} windows").finalize()


def flank_pair_scores(
    requests: Sequence[AlignmentRequest],
    device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> List[np.ndarray]:
    """Per --calculateFlankScore request (each with pairs), its [P] int64
    flank-corrected pair scores: K2 on `device`, then the host backtrace
    and flank penalty.  The mesh's flank windows take their scores from
    here.  A failure of the device work raises DeviceError."""
    pending = _aligned(requests, device, gapextend, nucprior,
                       f"{len(requests)} flank windows")
    pending.backtrace_flank()
    return [pending.pair_scores[id(req)] for req in requests]


def score_reads_vs_haplotypes(
    haps: Sequence[Haplotype],
    reads: WindowReads,
    device,
    gapextend: int = 3,
    nucprior: int = 2,
    use_map_qual_cap: bool = False,
) -> np.ndarray:
    """Log-likelihood matrix [H, R] for every (haplotype, read) pair
    (single-window wrapper over the batched path; the beam search and the
    HLA ranking and genotyping use it).  A failure of the device work
    raises DeviceError."""
    req = build_alignment_request(haps, reads, use_map_qual_cap)
    if req is None:
        return np.zeros((len(haps), len(reads)), np.float64)
    return _aligned([req], device, gapextend, nucprior,
                    f"{len(haps)} haplotypes x {len(reads)} reads").finalize()[0]
