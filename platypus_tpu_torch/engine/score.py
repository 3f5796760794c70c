"""Device half of window scoring, torch: batched pair alignment.

Twin of platypus_tpu/engine/score.py:613-873 and, for
--calculateFlankScore, :739-750 and :913-966 (flank_pair_scores is the
mesh's counterpart of _device_flank_scores).  Pair construction
(build_alignment_request, fill_deferred_pairs, RegionReadMatrix), the
per-pair backtrace and flank penalty (align_core) and the score ->
log-likelihood conversion (the native loglik batch and
window_loglik_from_pair_scores) are the JAX package's host code, used
unchanged.  What runs here is the device part: per read-length group the
deduplicated haplotype / read matrices upload once, and each chunk of pairs
runs gather/pad and the banded-alignment DP on the device -- K1 for plain
scores, K2 (traceback mode) for flank requests.  Results stay on the
device until copy_to_host() fetches them, one transfer per batch of K1
chunks and one per K2 chunk.

Unlike the JAX package, alignment never moves to the native host kernel or
to the scalar flank path: the device given is where it runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from platypus_tpu.engine import score as host_score
from platypus_tpu.engine.score import (LANE_BUCKETS, AlignmentRequest,
                                       WindowReads, _flank_pair_rows,
                                       _geom_bucket, build_alignment_request)
from platypus_tpu.models.haplotype import Haplotype
from platypus_tpu.ops.align_core import (N_LANES, calculate_flank_score,
                                         traceback_from_backpointers,
                                         unpack_backpointers)
from platypus_tpu.utils.observability import GLOBAL_METRICS as metrics

from ..ops.align_cuda import band_align_padded, band_align_traceback_padded
from ..ops.align_torch import gather_pad
from ..utils.backend import device_stage, fetch

_N_CHAR = ord("N")

# Bound on the int32 label block [n_steps*8, B] of one K2 launch; a read
# bucket whose largest lane chunk would exceed it is cut into smaller chunks.
FLANK_BP_BYTES = 256 << 20


class PendingAlignments(host_score.PendingAlignments):
    """In-flight device alignments for a batch of requests.

    `groups` has the JAX package's layout, with torch tensors as the K1
    device chunks; `flank_groups` holds the K2 chunks of flank requests as
    (owner requests, [((score, idx, bp), pair slice)]).  copy_to_host()
    fetches every chunk; finalize() then runs the host backtrace and flank
    penalty for the flank pairs, fills their pair scores, and runs the JAX
    package's host finalize, which sees the host score buffers its native
    path leaves, and returns its per-request [H, R] float64
    log-likelihood matrices."""

    def __init__(self, requests, gapextend: int, nucprior: int):
        super().__init__(requests, gapextend, nucprior)
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
        return super().finalize()


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
    return torch.from_numpy(idx).to(device)


def dispatch_alignment_requests(
    requests: Sequence[Optional[AlignmentRequest]],
    device: torch.device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> PendingAlignments:
    """Upload + launch every request's pair alignments on `device` without
    waiting for the results; returns a PendingAlignments to finalize()."""
    pending = PendingAlignments(requests, gapextend, nucprior)
    live = [r for r in requests if r is not None and r.n_pairs() > 0]

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


def _aligned(requests, device: torch.device, gapextend: int, nucprior: int,
             what: str) -> PendingAlignments:
    """Dispatch and copy to the host; a failure of the device work raises
    DeviceError, which the window containments let through."""
    with device_stage(f"device scoring of {what} on {device}"):
        pending = dispatch_alignment_requests(requests, device, gapextend,
                                              nucprior)
        pending.copy_to_host()
    return pending


def run_alignment_requests(
    requests: Sequence[Optional[AlignmentRequest]],
    device: torch.device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> List[np.ndarray]:
    """One [H, R] log-likelihood matrix per request (a zeros matrix for a
    None request).  A failure of the device work raises DeviceError."""
    return _aligned(requests, device, gapextend, nucprior,
                    f"{len(requests)} windows").finalize()


def flank_pair_scores(
    requests: Sequence[AlignmentRequest],
    device: torch.device,
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
    device: torch.device,
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
