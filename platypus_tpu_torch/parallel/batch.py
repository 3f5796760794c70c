"""Device half of the fused window-inference bridge, torch.

Twin of the device functions of platypus_tpu/parallel/batch.py.  The host
half -- bucketing windows into padded InferenceBatch arrays and mapping
results back to WindowInference -- is imported from there unchanged, so
both packages feed the fused program byte-identical arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from platypus_tpu.ops.likelihood import genotype_index_pairs
from platypus_tpu.parallel.batch import (WindowInference,
                                         build_inference_batches,
                                         inference_results_to_windows)

from ..ops.likelihood_torch import infer_window_batch
from ..utils.backend import fetch

# Fused-inference batches launched since the last reset (chip_smoke.py
# reads and resets it to show the main path ran inference on the card).
BATCHES = 0


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


def launch_fused_inference(loglik, onehot, hap_mask, var_mask, has_reads,
                           device: torch.device, em_iters: int = 100):
    """Upload one padded batch and queue the fused GL/EM/posterior program
    on `device`.  Returns (h1, h2, device result tuple)."""
    global BATCHES
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
    device: torch.device,
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


def run_device_inference(live, loglik_by_idx, n_individuals: int,
                         device: torch.device,
                         em_iters: int = 100) -> Dict[int, WindowInference]:
    """Dispatch + gather in one call."""
    return dispatch_device_inference(live, loglik_by_idx, n_individuals,
                                     device, em_iters=em_iters).gather()
