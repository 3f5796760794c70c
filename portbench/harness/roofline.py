"""The least time the card could take for the work a kernel launch needs:
the operations and bytes of K1 (the banded DP, csrc/band_align.cu) and K3
(the fused window inference, csrc/infer_window.cu), and the card's peak
rates.  Copied from chip_smoke.py (DP_OPS_PER_STEP, OPS_PER_PAIR,
needed_ops, pair_bytes, card_rates, infer_work, infer_bound); a share of a
roofline is that least time over the kernel's device time.
"""

from __future__ import annotations

import subprocess

import numpy as np

# The card's memory rate (H100 SXM data sheet) and per-SM, per-clock
# issue rates: int32 (16 lanes in each of 4 sub-partitions), fp32, and
# the MUFU's transcendentals.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
F32_PER_SM_CLOCK = 256
MUFU_PER_SM_CLOCK = 16
# The integer operations the banded DP needs per pair and step, counted as
# Hopper integer instructions in their fused forms (IADD3, and the DPX
# VIMNMX3 / VIADDMNMX): the even phase 77, the odd 78, the new haplotype
# base's 'N' cost 2 (chip_smoke.py gives the derivation).
DP_OPS_PER_STEP = 77 + 78 + 2
# Per pair once: both phases' init rows, the exit-row mins, the final add
# and shift.
K1_OPS_PER_PAIR = 16 + 16 + 2


def card_rates(index: int = 0):
    """(SMs x max SM clock in Hz) of card `index`: nvidia-smi's
    clocks.max.sm and torch's SM count."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * float(mhz) * 1e6


def k1_ops(read_len: np.ndarray, n_steps: int) -> int:
    """Integer operations K1 needs on pairs of these read lengths, n_steps
    = L2 + 8: row r of pair b exits at step read_len_b + r, so the pair
    needs read_len_b + 1 steps."""
    steps = int(np.minimum(read_len.astype(np.int64) + 1, n_steps).sum())
    return DP_OPS_PER_STEP * steps + K1_OPS_PER_PAIR * len(read_len)


def k1_bytes(hap_shape, seq_shape, index) -> int:
    """Bytes K1's pair entry must move: each matrix byte a pair touches,
    read once (pairs share rows), the four int32 index rows and the int32
    output.  A pair touches hap and gap-open columns ps .. ps + read_len +
    14 and read and quality columns 0 .. read_len - 1."""
    H, L1B = hap_shape
    A, L2 = seq_shape
    ph, pr, ps, rl = (np.asarray(a, np.int64) for a in index)

    def marks(rows, starts, ends, n_rows, width):
        # +1 at each touched run's start, -1 past its end, per row
        flat = (np.bincount(rows * (width + 1) + starts,
                            minlength=n_rows * (width + 1))
                - np.bincount(rows * (width + 1) + ends,
                              minlength=n_rows * (width + 1)))
        return flat.reshape(n_rows, width + 1)

    hap_touched = marks(ph, np.minimum(ps, L1B - 1),
                        np.minimum(ps + rl + 15, L1B), H, L1B)
    seq_touched = marks(pr, np.zeros_like(pr), np.clip(rl, 0, L2), A, L2)
    n_hap = int((np.cumsum(hap_touched, axis=1)[:, :L1B] > 0).sum())
    n_seq = int((np.cumsum(seq_touched, axis=1)[:, :L2] > 0).sum())
    return 2 * n_hap + 2 * n_seq + 5 * 4 * len(rl)


def k1_bound_s(hap_shape, seq_shape, index, clock_sms: float) -> float:
    """The least time of one K1 launch: the larger of its operations over
    the int32 rate and its bytes over the memory rate."""
    n_steps = seq_shape[1] + 8
    ops = k1_ops(np.asarray(index[3]), n_steps)
    return max(ops / (INT32_PER_SM_CLOCK * clock_sms),
               k1_bytes(hap_shape, seq_shape, index) / HBM_BYTES_PER_S)


def k3_work(arrays, iters):
    """(bytes, transcendentals, f32 operations) the fused inference needs on
    one batch of numpy inputs (loglik, onehot, hap_mask, h1, h2, var_mask,
    has_reads) and the EM iterations each window ran: every input read
    once and the seven outputs written once; per window the exact per-read
    branch, the contraction, the EM iterations and the outputs
    (chip_smoke.py infer_work)."""
    ll, oh, hm, h1, h2, vm, hr = arrays
    W, I = ll.shape[0], oh.shape[1]
    G = len(h1)
    n_bytes = sum(a.nbytes for a in arrays) + 4 * (
        4 * W * I * G + W * hm.shape[1] + W * vm.shape[1] + W)
    mufu = flops = 0
    for w in range(W):
        H, n, k = int(hm[w].sum()), int(hr[w].sum()), int(iters[w])
        if H == 0:
            continue
        reads = oh[w].any(axis=0)
        R, V = int(reads.sum()), int(vm[w].any(axis=1).sum())
        on = (h1 < H) & (h2 < H)
        Gw = int(on.sum())
        rows = ll[w][:H][:, reads]
        diff = np.abs(rows[h1[on]] - rows[h2[on]])
        exact = (h1[on] != h2[on])[:, None] & (diff > 1e-3) & (diff < 3.0)
        mufu += 2 * int(exact.sum()) + n * Gw
        flops += Gw * R * (4 * I + 6) + 4 * I * Gw
        mufu += k * (2 * n * Gw + n + Gw + H * H + 3 * H)
        flops += k * (8 * n * Gw + 4 * H * H + 4 * H)
        mufu += n * Gw + H + (n * Gw + n) + V * (H + 1 + n * (Gw + 1))
        flops += 5 * n * Gw * (1 + V)
    return n_bytes, mufu, flops


def k3_bound_s(work, clock_sms: float) -> float:
    """The least time of one K3 launch of k3_work `work`: the largest of
    its bytes, transcendentals and f32 operations over their rates."""
    n_bytes, mufu, flops = work
    return max(n_bytes / HBM_BYTES_PER_S,
               mufu / (MUFU_PER_SM_CLOCK * clock_sms),
               flops / (F32_PER_SM_CLOCK * clock_sms))
