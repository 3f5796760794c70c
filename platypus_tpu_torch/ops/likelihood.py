"""Genotype likelihoods, EM haplotype-frequency inference and variant
posteriors — exact host implementation (float64).

Numeric contract (reference files):

* read log-likelihood: ln P(r|h) = mLTOT*score + ln(1 - 10^(-mapq/10)),
  floored at -300 (or at ln P(map wrong) in HLA mode, with a smooth score
  truncation above 100) — chaplotype.pyx:594-676;
* genotype log-likelihood sums per-read ln(0.5 e^l1 + 0.5 e^l2) with the
  reference's three fast paths (same hap; |Δ|>=3; |Δ|<=1e-3) —
  cgenotype.pyx:131-189;
* per-individual likelihoods rescaled to exp(ll - max) clipped at 1e-300 —
  cpopulation.pyx:303-309;
* EM under HWE with factor-2 hets, new freq = responsibilities/2N,
  tol min(1e-3, 1/(4 nInd)), <=100 iterations — cpopulation.pyx:384-457,678;
* variant posterior: phred of prior/(prior + ratio(1-prior)) where ratio
  re-normalises frequencies with variant-carrying haplotypes zeroed —
  cpopulation.pyx:459-594.

The batched device versions (ops/likelihood_jax.py) mirror these formulas;
this module is the golden oracle for them and the path used for VCF output.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

MLTOT = -0.23025850929940459  # -ln(10)/10
LOG10E = 0.43429448190325182
LOG_HALF = -0.69314718055994529


def scores_to_logliks(
    scores: np.ndarray,       # [*] integer phred alignment scores
    mapq: np.ndarray,         # [*] mapping qualities
    use_map_qual_cap: bool = False,
) -> np.ndarray:
    """Alignment score -> ln P(read | hap) (chaplotype.pyx:619-676)."""
    scores = np.asarray(scores, dtype=np.float64)
    mapq = np.asarray(mapq, dtype=np.float64)
    prob_map_wrong = MLTOT * mapq
    with np.errstate(divide="ignore"):
        prob_map_right = np.log(1.0 - np.exp(prob_map_wrong))
    if use_map_qual_cap:
        cap = prob_map_wrong
        # Smooth truncation above threshold 100 with shape 0.5.
        thr, shape = 100.0, 0.5
        trunc = MLTOT * (thr - 1.0 + np.power(np.maximum(scores - thr + 1.0, 0.0), shape) / shape)
        out = np.where(scores > thr, trunc, MLTOT * scores + prob_map_right)
        return np.maximum(cap, out)
    cap = -300.0
    return np.maximum(cap, MLTOT * scores + prob_map_right)


def genotype_log_likelihoods(
    loglik: np.ndarray,        # [H, R] per-(hap, read) ln-likelihood
    hap1_idx: np.ndarray,      # [G]
    hap2_idx: np.ndarray,      # [G]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-genotype data log-likelihood and per-genotype goodness-of-fit sum.

    Returns (gl [G], gof_sum [G]) where gof_sum is
    sum_r max(log10lik1, log10lik2) (cgenotype.pyx:131-189); the caller
    divides by the good-read count and scales by -10.
    """
    l1 = loglik[hap1_idx]      # [G, R]
    l2 = loglik[hap2_idx]
    same = (hap1_idx == hap2_idx)[:, None]
    diff = np.abs(l1 - l2)
    mx = np.maximum(l1, l2)
    with np.errstate(over="ignore"):
        exact = np.log(0.5 * (np.exp(l1) + np.exp(l2)))
    per_read = np.where(
        same,
        l1,
        np.where(diff >= 3.0, LOG_HALF + mx, np.where(diff <= 1e-3, l1, exact)),
    )
    gl = per_read.sum(axis=1)
    gof_sum = (LOG10E * mx).sum(axis=1)
    return gl, gof_sum


def genotype_log_likelihoods_segments(
    loglik: np.ndarray,        # [H, R] per-(hap, read) ln-likelihood, reads
                               # ordered by sample (contiguous segments)
    hap1_idx: np.ndarray,      # [G]
    hap2_idx: np.ndarray,      # [G]
    bounds: np.ndarray,        # [I+1] segment bounds into the read axis
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample genotype GLs in one pass.

    The per-read mixture term of `genotype_log_likelihoods` depends only on
    the read column, so it is computed ONCE over all samples' reads; each
    sample then sums its contiguous column range.  Bit-identical to calling
    `genotype_log_likelihoods` per sample (same elementwise values, same
    pairwise summation over the same column order).

    Returns (gl [I, G], gof_sum [I, G])."""
    l1 = loglik[hap1_idx]      # [G, R]
    l2 = loglik[hap2_idx]
    same = (hap1_idx == hap2_idx)[:, None]
    diff = np.abs(l1 - l2)
    mx = np.maximum(l1, l2)
    # (Measured: subset-gather / precomputed-exp variants all LOSE to this
    # full-array form — numpy's vectorised exp/log cost ~1 ns/element
    # while advanced-indexing gathers cost several, so the mixture term is
    # cheapest computed densely.)
    with np.errstate(over="ignore"):
        exact = np.log(0.5 * (np.exp(l1) + np.exp(l2)))
    per_read = np.where(
        same,
        l1,
        np.where(diff >= 3.0, LOG_HALF + mx, np.where(diff <= 1e-3, l1, exact)),
    )
    log10_mx = LOG10E * mx
    I = len(bounds) - 1
    G = len(hap1_idx)
    gl = np.zeros((I, G))
    gof_sum = np.zeros((I, G))
    for i in range(I):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if hi > lo:
            gl[i] = per_read[:, lo:hi].sum(axis=1)
            gof_sum[i] = log10_mx[:, lo:hi].sum(axis=1)
    return gl, gof_sum


def genotype_log_likelihoods_segments_multi(
    loglik: np.ndarray,        # [H, R_total] columns from MANY windows,
                               # concatenated along the read axis
    hap1_idx: np.ndarray,      # [G]
    hap2_idx: np.ndarray,      # [G]
    segs: np.ndarray,          # [S, 2] (lo, hi) absolute column ranges
) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-window batched twin of genotype_log_likelihoods_segments: the
    per-read mixture matrix is computed ONCE over the concatenation of
    many windows' read columns (same H), then each (window, sample)
    segment sums its own column range.  Bit-identical to per-window calls:
    elementwise ops see the same values (contiguous either way) and each
    segment's pairwise sum reduces the same elements in the same order.

    Returns (gl [S, G], gof_sum [S, G])."""
    l1 = loglik[hap1_idx]
    l2 = loglik[hap2_idx]
    same = (hap1_idx == hap2_idx)[:, None]
    diff = np.abs(l1 - l2)
    mx = np.maximum(l1, l2)
    with np.errstate(over="ignore"):
        exact = np.log(0.5 * (np.exp(l1) + np.exp(l2)))
    per_read = np.where(
        same,
        l1,
        np.where(diff >= 3.0, LOG_HALF + mx, np.where(diff <= 1e-3, l1, exact)),
    )
    log10_mx = LOG10E * mx
    S = len(segs)
    G = len(hap1_idx)
    gl = np.zeros((S, G))
    gof_sum = np.zeros((S, G))
    for s in range(S):
        lo, hi = int(segs[s, 0]), int(segs[s, 1])
        if hi > lo:
            gl[s] = per_read[:, lo:hi].sum(axis=1)
            gof_sum[s] = log10_mx[:, lo:hi].sum(axis=1)
    return gl, gof_sum


def rescale_likelihoods(gl_by_ind: np.ndarray, n_reads: np.ndarray) -> np.ndarray:
    """[I, G] log-likelihoods -> relative likelihoods exp(ll-max) clipped at
    1e-300; individuals with no reads get all-1 (cpopulation.pyx:290-309)."""
    out = np.ones_like(gl_by_ind)
    has = n_reads > 0
    if has.any():
        mx = gl_by_ind[has].max(axis=1, keepdims=True)
        out[has] = np.maximum(1e-300, np.exp(gl_by_ind[has] - mx))
    return out


def em_haplotype_frequencies(
    likelihoods: np.ndarray,   # [I, G] relative likelihoods
    hap1_idx: np.ndarray,
    hap2_idx: np.ndarray,
    n_haps: int,
    n_reads: np.ndarray,       # [I]
    max_iters: int = 100,
    _allow_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """EM for haplotype frequencies (cpopulation.pyx:384-457,678-716).

    Returns (frequencies [n_haps], EM responsibilities [I, G], n_iters).

    The numpy body below is the oracle; when the native library is built,
    a C++ twin (native/src/em.cpp) runs instead — it replicates numpy's
    summation orders (pairwise on the fast axis, sequential on the outer)
    and passes a bitwise self-check battery before first use, so results
    are identical to the last bit (tests/test_native.py pins this)."""
    if _allow_native:
        from .. import native

        res = native.native_em(likelihoods, hap1_idx, hap2_idx, n_haps,
                               n_reads, max_iters)
        if res is not None:
            return res
    n_ind = likelihoods.shape[0]
    has_data = n_reads > 0
    n_with_data = int(has_data.sum())
    eps = min(1e-3, 1.0 / (n_ind * 4))
    freq = np.full(n_haps, 1.0 / n_haps)
    het_factor = 1.0 + (hap1_idx != hap2_idx)
    csr = np.zeros_like(likelihoods)
    iters = 0
    if n_with_data == 0:
        return freq, csr, 0
    lik = likelihoods[has_data]
    w = np.zeros_like(lik)  # responsibilities stay zero if max_iters <= 0
    while iters < max_iters:
        w = lik * (freq[hap1_idx] * freq[hap2_idx] * het_factor)[None, :]
        s = w.sum(axis=1, keepdims=True)
        w = np.divide(w, s, out=np.zeros_like(w), where=s > 0)
        new_freq = np.zeros(n_haps)
        np.add.at(new_freq, hap1_idx, w.sum(axis=0))
        np.add.at(new_freq, hap2_idx, w.sum(axis=0))
        new_freq /= 2.0 * n_with_data
        max_change = np.abs(freq - new_freq).max()
        freq = new_freq
        iters += 1
        if max_change <= eps:
            break
    csr[has_data] = w
    return freq, csr, iters


class WindowPosteriorContext:
    """Per-window precompute for variant posteriors: the variant-model
    weights w_var and the per-individual dot products P(data | variant
    model) depend only on the window's EM frequencies, so a window with V
    variants shares them instead of recomputing V times
    (cpopulation.pyx:459-594's outer loop hoisted).  Bit-identical to
    per-variant `variant_posterior_phred` calls: the hoisted values come
    from the same expressions over the same operands."""

    __slots__ = ("likelihoods", "frequencies", "h1", "h2", "factor",
                 "rows", "log_pv")

    def __init__(self, likelihoods: np.ndarray, frequencies: np.ndarray,
                 hap1_idx: np.ndarray, hap2_idx: np.ndarray,
                 n_reads: np.ndarray):
        self.likelihoods = likelihoods
        self.frequencies = frequencies
        self.h1 = hap1_idx
        self.h2 = hap2_idx
        self.factor = 1.0 + (hap1_idx != hap2_idx)
        w_var = self.factor * frequencies[hap1_idx] * frequencies[hap2_idx]
        self.rows = [i for i in range(likelihoods.shape[0]) if n_reads[i] != 0]
        log_pv = []
        for i in self.rows:
            pv = float(np.dot(w_var, likelihoods[i]))
            log_pv.append(math.log(pv) if pv > 0 else -708.0)
        self.log_pv = log_pv

    def posterior_phred(self, hap_has_variant: np.ndarray, prior: float) -> float:
        freqs_prime = np.where(hap_has_variant, 0.0, self.frequencies)
        sum_freqs = freqs_prime.sum()
        if sum_freqs > 0:
            freqs_prime = freqs_prime / sum_freqs
        w_novar = self.factor * freqs_prime[self.h1] * freqs_prime[self.h2]
        sum_log_var = 0.0
        sum_log_novar = 0.0
        for j, i in enumerate(self.rows):
            pn = float(np.dot(w_novar, self.likelihoods[i]))
            sum_log_var += self.log_pv[j]
            sum_log_novar += math.log(pn) if pn > 0 else -708.0
        return posterior_phred_from_log_ratio(sum_log_novar - sum_log_var, prior)


def variant_posterior_phred(
    likelihoods: np.ndarray,    # [I, G] relative likelihoods
    frequencies: np.ndarray,    # [n_haps]
    hap_has_variant: np.ndarray,  # [n_haps] bool
    hap1_idx: np.ndarray,
    hap2_idx: np.ndarray,
    n_reads: np.ndarray,        # [I]
    prior: float,
) -> float:
    """Model-averaged segregation test -> phred posterior
    (cpopulation.pyx:459-594)."""
    ctx = WindowPosteriorContext(likelihoods, frequencies, hap1_idx,
                                 hap2_idx, n_reads)
    return ctx.posterior_phred(hap_has_variant, prior)


def posterior_phred_from_log_ratio(log_ratio: float, prior: float) -> float:
    """phred posterior from ln(P(no var)/P(var)) and the variant prior
    (cpopulation.pyx:586-594); shared by the host and device paths."""
    from ..utils.maths import round_ref

    # int like Python 3's one-arg round returned here before; the VALUE
    # follows the reference's C round (ties away from zero).
    return int(round_ref(posterior_phred_unrounded(log_ratio, prior)))


def posterior_phred_unrounded(log_ratio: float, prior: float) -> float:
    """The pre-round phred posterior — exposed so the device-inference
    consumer can test how close a value sits to the integer rounding
    boundary (engine/caller.finish_window's f64-exactness guard)."""
    ratio = max(1e-300, math.exp(min(700.0, log_ratio)))
    return (
        -10.0 * (math.log10(ratio * (1.0 - prior)) - math.log10(prior + ratio * (1.0 - prior)))
    )


def call_genotypes(
    likelihoods: np.ndarray,      # [I, G]
    em_likelihoods: Optional[np.ndarray],
    n_reads: np.ndarray,
    use_em: bool = False,
) -> List[Optional[int]]:
    """Per-individual best-genotype index; None for no-data individuals.
    Ties keep the first index (strict > argmax, cpopulation.pyx:623-676)."""
    out: List[Optional[int]] = []
    source = em_likelihoods if use_em else likelihoods
    for i in range(likelihoods.shape[0]):
        if n_reads[i] == 0:
            out.append(None)
        else:
            out.append(int(np.argmax(source[i])))
    return out


_GT_PAIR_CACHE: dict = {}


def genotype_index_pairs(n_haps: int) -> Tuple[np.ndarray, np.ndarray]:
    """All unordered hap pairs in the reference's enumeration order
    (cgenotype.pyx:193-218: i <= j, i-major).  Memoized — the engine asks
    for the same few H values tens of thousands of times per run; callers
    treat the arrays as read-only constants."""
    cached = _GT_PAIR_CACHE.get(n_haps)
    if cached is not None:
        return cached
    h1 = []
    h2 = []
    for i in range(n_haps):
        for j in range(i, n_haps):
            h1.append(i)
            h2.append(j)
    pair = (np.array(h1, dtype=np.int64), np.array(h2, dtype=np.int64))
    pair[0].setflags(write=False)
    pair[1].setflags(write=False)
    if len(_GT_PAIR_CACHE) < 512:
        _GT_PAIR_CACHE[n_haps] = pair
    return pair
