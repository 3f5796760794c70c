"""Device half of window scoring, torch: batched pair alignment.

Twin of platypus_tpu/engine/score.py:613-873.  Pair construction
(build_alignment_request, fill_deferred_pairs, RegionReadMatrix) and the
score -> log-likelihood conversion (the native loglik batch and
window_loglik_from_pair_scores) are the JAX package's host code, used
unchanged.  What runs here is the device part: per read-length group the
deduplicated haplotype / read matrices upload once, and each chunk of
LANE_BUCKETS pairs runs gather/pad and the banded-alignment DP on the
device.  The scores stay on the device until finalize() copies them all in
one transfer.

Unlike the JAX package, alignment never moves to the native host kernel:
the device given is where it runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from platypus_tpu.engine import score as host_score
from platypus_tpu.engine.score import (LANE_BUCKETS, AlignmentRequest,
                                       WindowReads, _geom_bucket,
                                       build_alignment_request)
from platypus_tpu.models.haplotype import Haplotype

from ..ops.align_cuda import band_align_padded
from ..ops.align_torch import gather_pad
from ..utils.backend import DeviceError, fetch

_N_CHAR = ord("N")


class PendingAlignments(host_score.PendingAlignments):
    """In-flight device alignments for a batch of requests.

    `groups` has the JAX package's layout, with torch tensors as the
    device chunks.  copy_to_host() fetches every chunk in one transfer;
    finalize() then runs the JAX package's host finalize, which sees the
    host score buffers its native path leaves, and returns its per-request
    [H, R] float64 log-likelihood matrices."""

    def copy_to_host(self) -> None:
        """Copy every chunk's scores into its group's host buffer in one
        device->host transfer, and drop the device chunks."""
        pieces = [(out_scores, sl, dev[:take])
                  for _, out_scores, chunks in self.groups
                  for dev, sl, take in chunks]
        for (out_scores, sl, _), host in zip(pieces,
                                             fetch([p[2] for p in pieces])):
            out_scores[sl] = host
        for _, _, chunks in self.groups:
            chunks.clear()

    def finalize(self) -> List[np.ndarray]:
        self.copy_to_host()
        return super().finalize()


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
    if any(r.calculate_flank_score for r in live):
        raise NotImplementedError(
            "--calculateFlankScore needs the traceback kernel, which "
            "platypus_tpu_torch has not ported yet")

    # Group by read-length bucket; concatenate pair rows across windows.
    by_l2: dict = {}
    for req in live:
        by_l2.setdefault(req.sub_seq.shape[1], []).append(req)

    for L2, group in by_l2.items():
        # Deduplicated matrices (score.py:758-792): each window's unique
        # haplotypes and reads upload ONCE per group; per chunk only four
        # [lane] index vectors ship and the pair rows are gathered on the
        # device.  Row counts and hap width are bucketed exactly as in the
        # JAX package, so both see byte-identical matrices.
        H_tot = sum(req.hap_matrix.shape[0] for req in group)
        A_tot = sum(req.sub_seq.shape[0] for req in group)
        L1B = _geom_bucket(max(req.hap_matrix.shape[1] for req in group), 256)
        HB = _geom_bucket(H_tot, 256)
        AB = _geom_bucket(A_tot, 4096)
        hap_mat = np.full((HB, L1B), _N_CHAR, np.uint8)
        go_mat = np.zeros((HB, L1B), np.uint8)   # gap opens are <= 78
        seq_mat = np.zeros((AB, L2), np.uint8)
        qual_mat = np.zeros((AB, L2), np.uint8)
        ph_rows, pr_rows, ps_rows, ln_rows, owners = [], [], [], [], []
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
            owners.append(req)
            h_off += h
            a_off += a
        ph_all = np.concatenate(ph_rows)
        pr_all = np.concatenate(pr_rows)
        ps_all = np.concatenate(ps_rows)
        ln_all = np.concatenate(ln_rows)

        mats = [torch.from_numpy(m).to(device)
                for m in (hap_mat, go_mat, seq_mat, qual_mat)]

        total = len(ph_all)
        chunks = []
        done = 0
        while done < total:
            remaining = total - done
            # Smallest bucket that covers the remainder (or the largest).
            lane = next((b for b in LANE_BUCKETS if remaining <= b),
                        LANE_BUCKETS[-1])
            take = min(remaining, lane)
            sl = slice(done, done + take)
            idx = np.zeros((4, lane), np.int32)
            idx[0, :take] = ph_all[sl]
            idx[1, :take] = pr_all[sl]
            idx[2, :take] = ps_all[sl]
            idx[3, :take] = ln_all[sl]
            idx[3, take:] = min(8, L2)   # pad pairs: hap 0, read 0, seg 0
            idx_dev = torch.from_numpy(idx).to(device)
            padded = gather_pad(*mats, *idx_dev)
            dev = band_align_padded(*padded, gapextend=gapextend,
                                    nucprior=nucprior)
            chunks.append((dev, sl, take))
            done += take
        pending.groups.append((owners, np.empty(total, np.int64), chunks))

    return pending


def run_alignment_requests(
    requests: Sequence[Optional[AlignmentRequest]],
    device: torch.device,
    gapextend: int = 3,
    nucprior: int = 2,
) -> List[np.ndarray]:
    """One [H, R] log-likelihood matrix per request (a zeros matrix for a
    None request)."""
    return dispatch_alignment_requests(requests, device, gapextend,
                                       nucprior).finalize()


def score_reads_vs_haplotypes(
    haps: Sequence[Haplotype],
    reads: WindowReads,
    device: torch.device,
    gapextend: int = 3,
    nucprior: int = 2,
    use_map_qual_cap: bool = False,
) -> np.ndarray:
    """Log-likelihood matrix [H, R] for every (haplotype, read) pair
    (single-window wrapper over the batched path; the beam search uses
    it).  A failure of the device work raises DeviceError, which the
    window containment of the region stage lets through."""
    req = build_alignment_request(haps, reads, use_map_qual_cap)
    if req is None:
        return np.zeros((len(haps), len(reads)), np.float64)
    try:
        pending = dispatch_alignment_requests([req], device, gapextend,
                                              nucprior)
        pending.copy_to_host()
    except Exception as exc:
        raise DeviceError(f"device scoring of {len(haps)} haplotypes x "
                          f"{len(reads)} reads on {device} failed: {exc}") from exc
    return pending.finalize()[0]
