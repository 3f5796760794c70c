"""Variant candidate generation from aligned reads' CIGAR strings.

Mirrors Platypus src/cython/variant.pyx:458-752
(VariantCandidateGenerator): walk each read's CIGAR; insertions/deletions
need a flanking match run >= minFlank on either side; M segments are scanned
base-wise for mismatches with qual >= minBaseQual and no Ns, merging
mismatches closer than minFlank into MNPs; candidates closer than minFlank
to either read end are ignored.  Candidates dedupe into a dict keyed by
(pos, removed, added), accumulating supporting-read counts.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..io.bam import (
    CIGAR_D,
    CIGAR_EQ,
    CIGAR_H,
    CIGAR_I,
    CIGAR_M,
    CIGAR_N,
    CIGAR_P,
    CIGAR_S,
    CIGAR_X,
)
from .variant import PLATYPUS_VAR, Variant
from .. import native


class CandidateGenerator:
    def __init__(self, region, ref_file, min_map_qual: int, min_flank: int,
                 min_base_qual: int, gen_snps: bool = True, gen_indels: bool = True):
        self.ref_name, self.r_start, self.r_end = region
        self.ref_file = ref_file
        self.ref_seq_start = max(0, self.r_start - 2000)
        self.ref_seq_end = min(self.r_end + 2000, ref_file.refs[self.ref_name].length - 1)
        self.ref_seq = ref_file.get_sequence(self.ref_name, self.ref_seq_start, self.ref_seq_end)
        self.min_map_qual = min_map_qual
        self.min_flank = min_flank
        self.min_base_qual = min_base_qual
        self.gen_snps = gen_snps
        self.gen_indels = gen_indels
        # (pos, removed, added) -> support count.  Variant objects are only
        # constructed in get_candidates()/iter_counts consumers: the scans
        # emit ~10x more unique error singletons than surviving candidates,
        # and the tuple dict is ~5x cheaper per hit than a Variant heap.
        self.counts: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    def _add_platypus_candidate(self, pos: int, removed: bytes, added: bytes,
                                count: int = 1) -> None:
        if pos < 0:
            pos = 0  # Variant.__init__ clamps; the key must agree
        key = (pos, removed, added)
        self.counts[key] = self.counts.get(key, 0) + count

    def get_candidates(self, min_support: int = 1) -> List[Variant]:
        """Construct the surviving candidates as Variants.

        `min_support` pre-applies filterVariants' support threshold
        (variantFilter.pyx:98-171) to SNP/MNP candidates only — equal-length
        replacements are unchanged by left-normalisation, so distinct keys
        can never merge support downstream; indels always survive to the
        real filter."""
        out = [
            Variant(self.ref_name, pos, removed, added, n, PLATYPUS_VAR)
            for (pos, removed, added), n in self.counts.items()
            if n >= min_support or len(removed) != len(added)
        ]
        out.sort()
        return out

    # ------------------------------------------------------------------
    def add_candidates_from_reads(self, read_set, indices) -> None:
        """Scan a pile of reads (skipping QC-failed ones).

        Single-M reads — the overwhelming majority — go through one
        vectorised mismatch pass over the whole pile; reads with any other
        CIGAR walk the scalar per-read path."""
        idx = np.asarray(indices, dtype=np.int64)
        if len(idx) == 0:
            return
        idx = idx[~read_set.qc_fail[idx]]
        if len(idx) == 0:
            return
        c_lo = read_set.cigar_off[idx]
        single = (read_set.cigar_off[idx + 1] - c_lo) == 1
        scalar_rows = idx[~single]
        use_native = native.load() is not None
        # M segments accumulate (row, length, read_off, ref_off) and scan in
        # ONE native call per pile.
        batch_rows = batch_lens = None
        if single.any():
            words = read_set.cigar_flat[c_lo[single]].astype(np.int64)
            is_m = (words & 0xF) == CIGAR_M
            lens = words >> 4
            srows = idx[single]
            if self.gen_snps:
                batch = is_m & (lens >= self.min_flank)
                if batch.any():
                    if use_native:
                        batch_rows, batch_lens = srows[batch], lens[batch]
                    else:
                        self._scan_single_m_batch(read_set, srows[batch],
                                                  lens[batch])
            # Single-op reads that aren't plain M still walk the scalar path.
            scalar_rows = np.concatenate([scalar_rows, srows[~is_m]])
        # Indel/clipped reads: the CIGAR walk (flank-gated I/D extraction +
        # M-segment collection) runs in one C++ call; reads whose deletions
        # reach outside the reference cache come back for the Python walk
        # (it has file-backed reference access with the contig-end clamp).
        walked = None
        if use_native and len(scalar_rows):
            walked = native.native_scan_indel_reads(
                read_set, scalar_rows, self.ref_seq, self.ref_seq_start,
                self.min_flank, self.gen_snps, self.gen_indels)
        if walked is not None:
            cands, (sr, sl, so, sg), py_rows = walked
            for pos, removed, added, count in cands:
                self._add_platypus_candidate(pos, removed, added, count=count)
            if len(py_rows):
                # Rare cache-miss fallback rows: collect their segments
                # separately and append (arrays stay arrays for the common
                # case instead of round-tripping through Python tuples).
                py_sink: List[tuple] = []
                for i in py_rows:
                    self._scan_read(read_set, int(i), py_sink)
                if py_sink:
                    pr_, pl_, po_, pg_ = (np.array(col, np.int64)
                                          for col in zip(*py_sink))
                    sr = np.concatenate([sr, pr_])
                    sl = np.concatenate([sl, pl_])
                    so = np.concatenate([so, po_])
                    sg = np.concatenate([sg, pg_])
        elif use_native:
            m_sink: List[tuple] = []
            for i in scalar_rows:
                self._scan_read(read_set, int(i), m_sink)
            if m_sink:
                sr, sl, so, sg = (np.array(col, np.int64)
                                  for col in zip(*m_sink))
            else:
                sr = sl = so = sg = np.zeros(0, np.int64)
        else:
            for i in scalar_rows:
                self._scan_read(read_set, int(i), None)
            sr = None
        if use_native and (sr is not None and (len(sr) or batch_rows is not None)):
            if batch_rows is not None:
                z = np.zeros(len(batch_rows), np.int64)
                sr = np.concatenate([batch_rows.astype(np.int64), sr])
                sl = np.concatenate([batch_lens.astype(np.int64), sl])
                so = np.concatenate([z, so])
                sg = np.concatenate([z, sg])
            found = native.native_scan_m_segments(
                read_set, sr, sl, so, sg, self.ref_seq, self.ref_seq_start,
                self.min_flank, self.min_base_qual)
            for pos, removed, added, count in found:
                self._add_platypus_candidate(pos, removed, added, count=count)

    def _scan_single_m_batch(self, rs, rows: np.ndarray, lens: np.ndarray) -> None:
        """Vectorised equivalent of _scan_match_segment(read_off=0, ref_off=0)
        over a pile of single-M reads (variant.pyx:518-610 semantics)."""
        ref_arr = np.frombuffer(self.ref_seq, np.uint8)
        n_char = ord("N")
        L = rs.seq.shape[1]
        col = np.arange(L, dtype=np.int32)
        # Row-wise gather via a sliding-window view: one index per read
        # instead of one per cell (the elementwise take dominated this scan).
        ref_rows = (np.lib.stride_tricks.sliding_window_view(ref_arr, L)
                    if len(ref_arr) >= L else None)
        for done in range(0, len(rows), 16384):
            rws = rows[done : done + 16384]
            lns = lens[done : done + 16384]
            ref_base = (rs.pos[rws] - self.ref_seq_start).astype(np.int32)
            safe = ((ref_base >= 0) & (ref_base <= len(ref_arr) - L)
                    if ref_rows is not None else np.zeros(len(rws), bool))
            if safe.all():
                refm = ref_rows[ref_base]
            else:
                refm = np.empty((len(rws), L), np.uint8)
                if safe.any():
                    refm[safe] = ref_rows[ref_base[safe]]
                edge = ~safe
                refm[edge] = ref_arr.take(
                    ref_base[edge, None] + col[None, :], mode="clip")
            seq = rs.seq[rws]
            neq = seq != refm
            # Most reads match the reference exactly; run the flank/qual
            # masking only over rows with any mismatch at all.
            any_mm = neq.any(axis=1)
            if not any_mm.any():
                continue
            sel = np.nonzero(any_mm)[0]
            rws, lns, ref_base = rws[sel], lns[sel], ref_base[sel]
            refm, seq, neq = refm[sel], seq[sel], neq[sel]
            lo = np.maximum(self.min_flank, -ref_base)
            hi = np.minimum(np.minimum(lns, rs.rlen[rws] - self.min_flank),
                            len(ref_arr) - ref_base)
            mm = (
                (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
                & neq & (seq != n_char) & (refm != n_char)
                & (rs.qual[rws] >= self.min_base_qual)
            )
            rr, cc = np.nonzero(mm)
            if len(rr) == 0:
                continue
            breaks = (rr[1:] != rr[:-1]) | (cc[1:] - cc[:-1] > self.min_flank)
            bpos = np.nonzero(breaks)[0]
            starts = np.concatenate([[0], bpos + 1])
            ends = np.concatenate([bpos, [len(rr) - 1]])
            # Single-base runs (almost all of them: isolated SNP mismatches)
            # dedup in one np.unique pass — the same candidate repeats once
            # per supporting read, and per-hit Python costs dominate.
            single = starts == ends
            if single.any():
                rr_s = rr[starts[single]]
                cc_s = cc[starts[single]]
                absb = ref_base[rr_s].astype(np.int64) + cc_s
                key = absb * 256 + seq[rr_s, cc_s]
                uniq, first, counts = np.unique(key, return_index=True,
                                                return_counts=True)
                for k, fi, n in zip(uniq.tolist(), first.tolist(),
                                    counts.tolist()):
                    rb_i0 = k >> 8
                    pos = rb_i0 + self.ref_seq_start
                    removed = self.ref_seq[rb_i0 : rb_i0 + 1]
                    added = bytes(seq[rr_s[fi], cc_s[fi] : cc_s[fi] + 1])
                    self._add_platypus_candidate(pos, removed, added, count=n)
            for s, e in zip(starts[~single], ends[~single]):
                r = int(rr[s])
                i0 = int(cc[s])
                i1 = int(cc[e])
                rb = int(ref_base[r])
                pos = rb + i0 + self.ref_seq_start
                removed = self.ref_seq[rb + i0 : rb + i1 + 1]
                added = bytes(seq[r, i0 : i1 + 1])
                self._add_platypus_candidate(pos, removed, added)

    def _scan_read(self, rs, i: int, m_sink=None) -> None:
        """Scalar CIGAR walk.  With `m_sink` given, qualifying M segments are
        appended as (row, length, read_off, ref_off) for one batched native
        scan instead of scanning inline."""
        read_start = int(rs.pos[i])
        read_len = int(rs.rlen[i])
        seq = rs.seq[i]
        qual = rs.qual[i]
        # Fast path: single-M reads (the overwhelming majority) skip the
        # CIGAR materialisation entirely.
        c_lo = int(rs.cigar_off[i])
        c_hi = int(rs.cigar_off[i + 1])
        if c_hi - c_lo == 1:
            word = int(rs.cigar_flat[c_lo])
            op = word & 0xF
            length = word >> 4
            if op == CIGAR_M:
                if self.gen_snps and length >= self.min_flank:
                    if m_sink is not None:
                        m_sink.append((i, length, 0, 0))
                    else:
                        self._scan_match_segment(seq, qual, read_start, 0, 0,
                                                 length, read_len)
                return
        cigar = rs.cigar_ops(i)
        n_ops = len(cigar)
        ref_off = 0
        read_off = 0
        for ci in range(n_ops):
            op = int(cigar[ci, 0])
            length = int(cigar[ci, 1])
            if op == CIGAR_I:
                flank_ok = (
                    (ci > 0 and cigar[ci - 1, 0] == CIGAR_M and cigar[ci - 1, 1] >= self.min_flank)
                    or (ci < n_ops - 1 and cigar[ci + 1, 0] == CIGAR_M
                        and cigar[ci + 1, 1] >= self.min_flank)
                )
                if not flank_ok:
                    read_off += length
                    continue
                inserted = bytes(seq[read_off : read_off + length])
                if b"N" not in inserted and self.gen_indels:
                    self._add_platypus_candidate(read_start + ref_off - 1, b"", inserted)
                read_off += length
            elif op == CIGAR_D:
                flank_ok = (
                    (ci > 0 and cigar[ci - 1, 0] == CIGAR_M and cigar[ci - 1, 1] >= self.min_flank)
                    or (ci < n_ops - 1 and cigar[ci + 1, 0] == CIGAR_M
                        and cigar[ci + 1, 1] >= self.min_flank)
                )
                if not flank_ok:
                    ref_off += length
                    continue
                deleted = self.ref_file.get_sequence(
                    self.ref_name, read_start + ref_off, read_start + ref_off + length
                )
                if b"N" not in deleted and self.gen_indels:
                    self._add_platypus_candidate(read_start + ref_off - 1, deleted, b"")
                ref_off += length
            elif op in (CIGAR_M, CIGAR_EQ, CIGAR_X):
                if op == CIGAR_EQ or (length < self.min_flank and op == CIGAR_M):
                    read_off += length
                    ref_off += length
                    continue
                if self.gen_snps:
                    if m_sink is not None:
                        m_sink.append((i, length, read_off, ref_off))
                    else:
                        self._scan_match_segment(seq, qual, read_start,
                                                 read_off, ref_off, length,
                                                 read_len)
                read_off += length
                ref_off += length
            elif op == CIGAR_N:
                ref_off += length
            elif op == CIGAR_S:
                read_off += length
                # Leading soft clip: pos was adjusted left, so move ref too
                # (variant.pyx:699-705).
                if ci == 0:
                    ref_off += length
            elif op in (CIGAR_H, CIGAR_P):
                continue

    def _scan_match_segment(self, seq, qual, read_start: int, read_off: int,
                            ref_off: int, length: int, read_len: int) -> None:
        """SNP/MNP scan of one M segment (variant.pyx:518-610), vectorised.

        The reference's run-merging is equivalent to grouping qualifying
        mismatch positions by successive gaps <= minFlank (a closing match
        at gap d can only precede a mismatch at gap > d, so explicit run
        closing never changes the grouping).
        """
        min_flank = self.min_flank
        ref_seq = self.ref_seq
        n_char = ord("N")

        ref_base = (ref_off + read_start) - self.ref_seq_start
        # Candidate indices within the segment, honouring the read-edge and
        # reference-cache bounds.
        lo = min_flank if read_off == 0 else 0
        hi = min(length, read_len - min_flank - read_off)
        lo = max(lo, -ref_base)
        hi = min(hi, len(ref_seq) - ref_base)
        if hi <= lo:
            return

        read_slice = seq[read_off + lo : read_off + hi]
        ref_slice = np.frombuffer(ref_seq[ref_base + lo : ref_base + hi], np.uint8)
        qual_slice = qual[read_off + lo : read_off + hi]
        mm = (
            (read_slice != ref_slice)
            & (read_slice != n_char)
            & (ref_slice != n_char)
            & (qual_slice >= self.min_base_qual)
        )
        positions = np.nonzero(mm)[0]
        if len(positions) == 0:
            return
        # Group by gaps > minFlank.
        breaks = np.nonzero(np.diff(positions) > min_flank)[0]
        group_starts = np.concatenate([[0], breaks + 1])
        group_ends = np.concatenate([breaks, [len(positions) - 1]])
        for gs, ge in zip(group_starts, group_ends):
            i0 = int(positions[gs]) + lo
            i1 = int(positions[ge]) + lo
            ref_bytes = ref_seq[ref_base + i0 : ref_base + i1 + 1]
            read_bytes = bytes(seq[read_off + i0 : read_off + i1 + 1])
            self._add_platypus_candidate(ref_base + i0 + self.ref_seq_start,
                                          ref_bytes, read_bytes)
