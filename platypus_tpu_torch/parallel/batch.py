"""Bridge from prepared windows to fixed-shape fused inference batches.

The per-window inference math (genotype GLs, EM, posterior ratios -- the
reference's hot loop #2, cpopulation.pyx:283-457) is a pile of small dense
ops; running it window-by-window on the device would drown in launch
latency.  Instead the region's windows are bucketed by (haplotype count,
read count, variant count) into a few fixed shapes, padded with masks, and
each bucket runs ONE fused program (ops/likelihood_torch.infer_window_batch).

The host half (bucketing windows into padded InferenceBatch arrays and
mapping results back to WindowInference) is plain numpy: the device-owner
service's clients, the host workers, use it without torch.  The device
half (launch_fused_inference, dispatch_device_inference, PendingInference)
imports torch when it runs.  The float64 host path (ops/likelihood.py)
remains the numeric oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..candidates.variant import Variant
from ..ops.likelihood import genotype_index_pairs
from ..utils.backend import fetch

# Fused-inference batches launched since the last reset (chip_smoke.py
# reads and resets it to show the main path ran inference on the card).
BATCHES = 0

def geom_bucket(n: int, base: int = 2) -> int:
    """Smallest base*{1,1.5}*2^k >= n (bounds compiled shapes, <=33% pad)."""
    b = base
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


def enumerate_window_variants(all_haps) -> List[Variant]:
    """Unique variants of a window's haplotypes in deterministic first-seen
    order — the exact enumeration finish_window's posterior loop uses, so
    device ratio rows map back by position."""
    out: List[Variant] = []
    seen = set()
    for hap in all_haps:
        for v in hap.variants:
            if v not in seen:
                seen.add(v)
                out.append(v)
    return out


@dataclass
class WindowInference:
    """Fused inference results for one window, gathered back to host.

    GL/GOF emission always comes from the f64 host oracle
    (engine/caller.finish_window), so only the EM tables and posterior
    ratios are transferred from the device."""

    em: np.ndarray             # [I, G_w] EM responsibilities
    frequencies: np.ndarray    # [H_w]
    ratios: Dict[Variant, float]  # ln P(no var) - ln P(var)
    # EM convergence-test margin (ops/likelihood_torch.em_frequencies_log):
    # min over iterations of |max_freq_change - tol|.  inf when the loop
    # never ran.  finish_window's f64-exactness guard host-recomputes the
    # window when this is small (the f32/f64 EMs may have stopped at
    # different iterations).
    em_margin: float = float("inf")


class PendingInference:
    """In-flight fused inference for a region's windows: torch queues the
    work on the device's stream, and gather() copies the consumed outputs
    (EM tables, frequencies, ratios, margins) to the host in one
    transfer."""

    def __init__(self):
        self.buckets: list = []  # (items, h1, h2, device result tuple)

    def gather(self) -> Dict[int, WindowInference]:
        consumed = [t for _, _, _, dev in self.buckets
                    for t in (dev[1], dev[2], dev[4], dev[6])]
        host = iter(fetch(consumed))
        out: Dict[int, WindowInference] = {}
        for items, h1, h2, _dev in self.buckets:
            em, freq, ratio, margin = (np.asarray(next(host), np.float64)
                                       for _ in range(4))
            out.update(inference_results_to_windows(items, h1, h2, em, freq,
                                                    ratio, margin))
        self.buckets = []
        return out


@dataclass
class InferenceBatch:
    """One bucketed, padded window batch ready for the fused program —
    either dispatched locally (dispatch_device_inference) or shipped to
    the device-owner service (engine/device_service.py).  The array
    fields are exactly infer_window_batch's inputs except h1/h2, which
    the consumer derives from hap_mask.shape[1]."""

    items: list                # (w_idx, prep, ll, variants)
    loglik: np.ndarray         # [W, Hb, Rb] float32
    onehot: np.ndarray         # [W, I, Rb] float32
    hap_mask: np.ndarray       # [W, Hb] bool
    var_mask: np.ndarray       # [W, Vb, Hb] bool
    has_reads: np.ndarray      # [W, I] bool

    def arrays(self) -> dict:
        return dict(loglik=self.loglik, onehot=self.onehot,
                    hap_mask=self.hap_mask, var_mask=self.var_mask,
                    has_reads=self.has_reads)


def build_inference_batches(
    live: Sequence[Tuple[int, object]],   # (window index, PreparedWindow)
    loglik_by_idx: Dict[int, np.ndarray],
    n_individuals: int,
) -> List[InferenceBatch]:
    """Bucket + pad every live window into fixed-shape batches."""
    groups: Dict[Tuple[int, int, int], list] = {}
    for w_idx, prep in live:
        ll = loglik_by_idx[w_idx]
        H = len(prep.all_haps)
        R = len(prep.reads)
        if H == 0:
            continue
        if ll.size == 0:
            ll = np.zeros((H, R), np.float64)
        variants = enumerate_window_variants(prep.all_haps)
        key = (geom_bucket(H), geom_bucket(max(1, R), 64),
               geom_bucket(max(1, len(variants))))
        groups.setdefault(key, []).append((w_idx, prep, ll, variants))

    batches: List[InferenceBatch] = []
    I = n_individuals
    for (Hb, Rb, Vb), items in groups.items():
        Wb = geom_bucket(len(items))
        loglik = np.zeros((Wb, Hb, Rb), np.float32)
        onehot = np.zeros((Wb, I, Rb), np.float32)
        hap_mask = np.zeros((Wb, Hb), bool)
        var_mask = np.zeros((Wb, Vb, Hb), bool)
        has_reads = np.zeros((Wb, I), bool)
        for k, (w_idx, prep, ll, variants) in enumerate(items):
            H, R = ll.shape
            loglik[k, :H, :R] = ll
            if R:
                onehot[k, prep.reads.sample_idx, np.arange(R)] = 1.0
            hap_mask[k, :H] = True
            # Invert the (variant in hap) test: iterate each hap's own
            # (small) variant set instead of V x H membership probes.
            vidx = {v: vi for vi, v in enumerate(variants)}
            for h, hap in enumerate(prep.all_haps):
                rows = [vidx[v] for v in hap.variants if v in vidx]
                if rows:
                    var_mask[k, rows, h] = True
            n_good = np.bincount(prep.reads.sample_idx[prep.reads.is_good],
                                 minlength=I) if R else np.zeros(I, np.int64)
            has_reads[k] = n_good > 0
        batches.append(InferenceBatch(items, loglik, onehot, hap_mask,
                                      var_mask, has_reads))
    return batches


def inference_results_to_windows(
    items: list, h1: np.ndarray, h2: np.ndarray,
    em_h: np.ndarray, freq_h: np.ndarray, ratio_h: np.ndarray,
    margin_h: np.ndarray,
) -> Dict[int, WindowInference]:
    """Map one batch's (host-side) result arrays back to WindowInference
    per window index — shared by the local gather and the service client."""
    out: Dict[int, WindowInference] = {}
    for k, (w_idx, prep, ll, variants) in enumerate(items):
        H, R = ll.shape
        cols = np.nonzero((h1 < H) & (h2 < H))[0]
        out[w_idx] = WindowInference(
            em=em_h[k][:, cols],
            frequencies=freq_h[k][:H],
            ratios={v: float(ratio_h[k, vi])
                    for vi, v in enumerate(variants)},
            em_margin=float(margin_h[k]),
        )
    return out


def launch_fused_inference(loglik, onehot, hap_mask, var_mask, has_reads,
                           device, em_iters: int = 100):
    """Upload one padded batch and queue the fused GL/EM/posterior program
    on `device`; the single launch of both the in-process pipeline
    (dispatch_device_inference) and the device-owner service
    (engine/device_service.py).  Returns (h1, h2, device result tuple)."""
    global BATCHES
    import torch

    from ..ops.likelihood_torch import infer_window_batch

    Hb = hap_mask.shape[1]
    h1, h2 = genotype_index_pairs(Hb)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = infer_window_batch(up(loglik), up(onehot), up(hap_mask),
                             up(h1.astype(np.int64)), up(h2.astype(np.int64)),
                             up(var_mask), up(has_reads), em_iters=em_iters)
    BATCHES += 1
    return h1, h2, dev


def dispatch_device_inference(
    live: Sequence[Tuple[int, object]],   # (window index, PreparedWindow)
    loglik_by_idx: Dict[int, np.ndarray],
    n_individuals: int,
    device,
    em_iters: int = 100,
) -> PendingInference:
    """Launch the fused program over every live window, bucketed by shape;
    returns a PendingInference to gather() later."""
    pending = PendingInference()
    for batch in build_inference_batches(live, loglik_by_idx, n_individuals):
        h1, h2, dev = launch_fused_inference(
            batch.loglik, batch.onehot, batch.hap_mask, batch.var_mask,
            batch.has_reads, device, em_iters=em_iters)
        pending.buckets.append((batch.items, h1, h2, dev))
    return pending


def run_device_inference(live, loglik_by_idx, n_individuals: int, device,
                         em_iters: int = 100) -> Dict[int, WindowInference]:
    """Dispatch + gather in one call."""
    return dispatch_device_inference(live, loglik_by_idx, n_individuals,
                                     device, em_iters=em_iters).gather()
