"""Fused per-window genotype-likelihood -> EM -> posterior inference, torch.

Twin of platypus_tpu/ops/likelihood_jax.py.  The JAX version vmaps a
per-window function; here the window axis W is written out as the leading
dimension of every tensor.  The float64 host kernels in
ops/likelihood.py stay the numeric oracle, and the engine's
f64-exactness guard (engine/caller._device_window_needs_host)
decides per window whether these f32 results may be emitted.

The [G, R] x [R, I] contractions must run in full f32 (never TF32 or
bf16): `infer_window_batch` sets and checks that before it runs, and so
does `variant_posterior_ratio` for its two dot products.

The linear-space functions (genotype_log_likelihoods, em_frequencies,
em_frequencies_resp, window_em_batch, variant_posterior_ratio) are the
twins of the ones the JAX package's mesh demo step runs
(parallel/mesh.py build_calling_step); the engine's inference runs in
log space (infer_window_batch).
"""

from __future__ import annotations

import torch

LOG_HALF = -0.69314718055994529
MLTOT = -0.23025850929940459
LOG10E = 0.43429448190325182
LOG2 = 0.6931471805599453
_NEG_INF = float("-inf")


def scores_to_logliks(scores, mapq, cap: float = -300.0,
                      use_map_qual_cap: bool = False):
    """Twin of likelihood_jax.scores_to_logliks_jax (f32 phred scores ->
    per-read ln-likelihoods; use_map_qual_cap is the HLA mode)."""
    prob_map_wrong = MLTOT * mapq
    prob_map_right = torch.log1p(-torch.exp(prob_map_wrong))
    if use_map_qual_cap:
        thr, shape = 100.0, 0.5
        trunc = MLTOT * (thr - 1.0 + torch.pow(
            torch.clamp_min(scores - thr + 1.0, 0.0), shape) / shape)
        out = torch.where(scores > thr, trunc, MLTOT * scores + prob_map_right)
        return torch.maximum(prob_map_wrong, out)
    return torch.clamp_min(MLTOT * scores + prob_map_right, cap)


def _require_full_f32_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("full-f32 matmul could not be set")


def _per_read_genotype(loglik, h1, h2):
    """loglik [W, H, R] -> (per-read genotype log-likelihood [W, G, R]
    with the reference's three fast paths, max(l1, l2) [W, G, R])."""
    l1 = loglik[:, h1]            # [W, G, R]
    l2 = loglik[:, h2]
    same = (h1 == h2)[None, :, None]
    diff = torch.abs(l1 - l2)
    mx = torch.maximum(l1, l2)
    exact = mx + torch.log1p(torch.exp(-diff)) + LOG_HALF
    per_read = torch.where(
        same, l1,
        torch.where(diff >= 3.0, LOG_HALF + mx,
                    torch.where(diff <= 1e-3, l1, exact)))
    return per_read, mx


def genotype_log_likelihoods(loglik, h1, h2, read_mask):
    """loglik [W, H, R], read_mask [W, R] -> gl [W, G] summed over the
    masked reads; twin of likelihood_jax.genotype_log_likelihoods_jax."""
    per_read, _mx = _per_read_genotype(loglik, h1.long(), h2.long())
    return torch.where(read_mask[:, None, :], per_read, 0.0).sum(dim=2)


def genotype_gl_gof(loglik, h1, h2, sample_onehot):
    """loglik [W, H, R], sample_onehot [W, I, R] -> (gl [W, I, G],
    gof_sum [W, I, G]); twin of likelihood_jax.genotype_gl_gof_jax."""
    per_read, mx = _per_read_genotype(loglik, h1, h2)
    oh_t = sample_onehot.transpose(1, 2)          # [W, R, I]
    gl = torch.matmul(per_read, oh_t)             # [W, G, I]
    gof = torch.matmul(LOG10E * mx, oh_t)
    return gl.transpose(1, 2), gof.transpose(1, 2)


def rescale_likelihoods(gl, geno_mask, has_reads):
    """gl [W, I, G] -> relative likelihoods, masked genotypes -> 0."""
    gm = geno_mask[:, None, :]
    neg = torch.where(gm, gl, _NEG_INF)
    mx = torch.amax(neg, dim=2, keepdim=True)
    lik = torch.clamp_min(torch.exp(gl - mx), 1e-300)
    lik = torch.where(gm, lik, 0.0)
    return torch.where(has_reads[:, :, None], lik,
                       torch.where(gm, 1.0, 0.0).to(lik.dtype))


def _per_window(idx, n_windows: int):
    """Genotype hap indices, shared [G] or per window [W, G] -> [W, G]."""
    idx = idx.long()
    return idx.expand(n_windows, -1) if idx.dim() == 1 else idx


def em_frequencies_resp(likelihoods, h1, h2, n_haps_max: int, hap_mask,
                        has_reads, n_iters: int = 100, tol=None):
    """Linear-space EM over haplotype frequencies for W windows at once;
    twin of likelihood_jax.em_frequencies_resp_jax.

    likelihoods [W, I, G], h1/h2 [G] or [W, G], hap_mask [W, H],
    has_reads [W, I].  Returns (frequencies [W, H], responsibilities
    [W, I, G]).  With `tol` a window freezes once its max frequency
    change is <= tol, as the JAX version's vmapped while_loop leaves it,
    while the others run on (the same masked loop as em_frequencies_log);
    tol None runs n_iters plain iterations."""
    dt = likelihoods.dtype
    W = likelihoods.shape[0]
    h1 = _per_window(h1, W)
    h2 = _per_window(h2, W)
    n_haps = hap_mask.sum(dim=1).clamp_min(1)
    n_with_data = has_reads.sum(dim=1).clamp_min(1)
    het = 1.0 + (h1 != h2).to(dt)                                     # [W, G]
    lik = torch.where(has_reads[:, :, None], likelihoods, 0.0)
    freq = torch.where(hap_mask, (1.0 / n_haps.to(dt))[:, None], 0.0)
    w = torch.zeros_like(lik)
    denom = (2.0 * n_with_data.to(dt))[:, None]
    done = torch.zeros(W, dtype=torch.bool, device=lik.device)
    for _ in range(n_iters):
        new_w = lik * (freq.gather(1, h1) * freq.gather(1, h2) * het)[:, None, :]
        s = new_w.sum(dim=2, keepdim=True)
        new_w = torch.where(s > 0, new_w / torch.where(s > 0, s, 1.0), 0.0)
        resp = new_w.sum(dim=1)                                       # [W, G]
        new = torch.zeros((W, n_haps_max), dtype=dt, device=lik.device)
        new = new.scatter_add(1, h1, resp).scatter_add(1, h2, resp) / denom
        new = torch.where(hap_mask, new, 0.0)
        if tol is None:
            freq, w = new, new_w
            continue
        max_change = torch.amax(torch.abs(new - freq), dim=1)
        freq = torch.where(done[:, None], freq, new)
        w = torch.where(done[:, None, None], w, new_w)
        done = done | (max_change <= tol)
    return freq, torch.where(has_reads[:, :, None], w, 0.0)


def em_frequencies(likelihoods, h1, h2, n_haps_max: int, hap_mask,
                   has_reads, n_iters: int = 100):
    """Frequencies [W, H] of em_frequencies_resp with n_iters fixed
    iterations; twin of likelihood_jax.em_frequencies_jax."""
    return em_frequencies_resp(likelihoods, h1, h2, n_haps_max, hap_mask,
                               has_reads, n_iters)[0]


def window_em_batch(gl, h1, h2, geno_mask, hap_mask, has_reads,
                    n_iters: int = 100):
    """gl [W, I, G] log-likelihoods -> (likelihoods [W, I, G],
    frequencies [W, Hmax]); twin of likelihood_jax.window_em_batch, whose
    h1/h2 are per window ([W, G]; a shared [G] works too)."""
    lik = rescale_likelihoods(gl, geno_mask, has_reads)
    return lik, em_frequencies(lik, h1, h2, hap_mask.shape[1], hap_mask,
                               has_reads, n_iters)


def variant_posterior_ratio(likelihoods, frequencies, hap_has_variant, h1,
                            h2, has_reads):
    """likelihoods [W, I, G], frequencies [W, H], hap_has_variant [W, H],
    has_reads [W, I] -> [W] sum_i (ln P(data_i|no var) - ln P(data_i|var));
    twin of likelihood_jax.variant_posterior_ratio_jax.  Its two dot
    products run in full f32, as the JAX version's Precision.HIGHEST."""
    _require_full_f32_matmul()
    W = likelihoods.shape[0]
    h1 = _per_window(h1, W)
    h2 = _per_window(h2, W)
    fp = torch.where(hap_has_variant, 0.0, frequencies)
    s = fp.sum(dim=1, keepdim=True)
    fp = torch.where(s > 0, fp / torch.where(s > 0, s, 1.0), fp)
    factor = 1.0 + (h1 != h2).to(likelihoods.dtype)
    w_var = factor * frequencies.gather(1, h1) * frequencies.gather(1, h2)
    w_novar = factor * fp.gather(1, h1) * fp.gather(1, h2)
    pv = torch.matmul(likelihoods, w_var[:, :, None])[..., 0]       # [W, I]
    pn = torch.matmul(likelihoods, w_novar[:, :, None])[..., 0]
    log_min = -708.0
    lv = torch.where(pv > 0, torch.log(torch.where(pv > 0, pv, 1.0)), log_min)
    ln = torch.where(pn > 0, torch.log(torch.where(pn > 0, pn, 1.0)), log_min)
    return torch.where(has_reads, ln - lv, 0.0).sum(dim=1)


def _lse(x, dim, keepdim: bool = False):
    """Masked logsumexp: all--inf reductions give -inf (not nan)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    out = m_safe + torch.log(torch.sum(torch.exp(x - m_safe), dim=dim,
                                       keepdim=True))
    out = torch.where(finite, out, _NEG_INF)
    return out if keepdim else out.squeeze(dim)


def em_frequencies_log(log_lik, h1, h2, n_haps_max: int, hap_mask, has_reads,
                       n_iters: int = 100, tol: float = 1e-3):
    """Log-domain EM over haplotype frequencies for W windows at once;
    twin of likelihood_jax.em_frequencies_log_jax.

    log_lik [W, I, G], hap_mask [W, H], has_reads [W, I].  Returns
    (log_freq [W, H], responsibilities [W, I, G], convergence margin [W]).

    The JAX version runs a vmapped while_loop that freezes each window's
    whole carry once that window converges.  Here every window runs
    n_iters masked iterations: a window stops updating (frequencies,
    responsibilities and margin alike) after the iteration at which it
    converged, which gives the same results with no host sync per
    iteration."""
    dt = log_lik.dtype
    log_het = torch.where(h1 != h2, LOG2, 0.0).to(dt)               # [G]
    ll = torch.where(has_reads[:, :, None], log_lik, _NEG_INF)      # [W, I, G]
    n_haps = hap_mask.sum(dim=1).clamp_min(1)
    n_with_data = has_reads.sum(dim=1).clamp_min(1)
    log_freq = torch.where(hap_mask, -torch.log(n_haps.to(dt))[:, None],
                           _NEG_INF)
    counts = (torch.nn.functional.one_hot(h1.long(), n_haps_max)
              + torch.nn.functional.one_hot(h2.long(), n_haps_max)).to(dt)
    logA = torch.where(counts > 0, torch.log(torch.clamp_min(counts, 1e-30)),
                       _NEG_INF)                                     # [G, H]
    log_denom = torch.log(2.0 * n_with_data.to(dt))                 # [W]
    w = torch.full_like(ll, _NEG_INF)
    margin = torch.full(log_lik.shape[:1], float("inf"), dtype=dt,
                        device=log_lik.device)
    done = torch.zeros(log_lik.shape[:1], dtype=torch.bool,
                       device=log_lik.device)

    for _ in range(n_iters):
        log_w = ll + (log_freq[:, h1] + log_freq[:, h2] + log_het)[:, None, :]
        log_s = _lse(log_w, 2, keepdim=True)
        new_w = torch.where(torch.isfinite(log_s), log_w - log_s, _NEG_INF)
        log_resp = _lse(new_w, 1)                                    # [W, G]
        new = _lse(log_resp[:, :, None] + logA[None], 1) - log_denom[:, None]
        new = torch.where(hap_mask, new, _NEG_INF)                   # [W, H]
        # Convergence is the reference's LINEAR max-change test.
        max_change = torch.amax(torch.abs(torch.exp(new) - torch.exp(log_freq)),
                                dim=1)
        active = ~done
        margin = torch.where(active,
                             torch.minimum(margin, torch.abs(max_change - tol)),
                             margin)
        log_freq = torch.where(active[:, None], new, log_freq)
        w = torch.where(active[:, None, None], new_w, w)
        done = done | (max_change <= tol)

    resp = torch.where(has_reads[:, :, None], torch.exp(w), 0.0)
    return log_freq, resp, margin


def variant_posterior_logratio(gl_rel, log_freq, hap_has_variant, h1, h2,
                               has_reads):
    """gl_rel [W, I, G], log_freq [W, H], hap_has_variant [W, V, H] ->
    [W, V] sum_i (ln P(data_i|no var) - ln P(data_i|var)); twin of
    likelihood_jax.variant_posterior_logratio_jax."""
    log_fp = torch.where(hap_has_variant, _NEG_INF, log_freq[:, None, :])
    log_s = _lse(log_fp, 2, keepdim=True)
    log_fp = torch.where(torch.isfinite(log_s), log_fp - log_s, log_fp)
    log_het = torch.where(h1 != h2, LOG2, 0.0).to(gl_rel.dtype)
    lw_var = (log_het + log_freq[:, h1] + log_freq[:, h2])[:, None, :]
    lw_novar = log_het + log_fp[:, :, h1] + log_fp[:, :, h2]         # [W, V, G]
    log_min = -708.0

    def log_dot(lw):
        t = lw[:, :, None, :] + gl_rel[:, None, :, :]               # [W, V, I, G]
        m = torch.amax(t, dim=3, keepdim=True)
        finite = torch.isfinite(m[..., 0])
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        out = m_safe[..., 0] + torch.log(torch.sum(torch.exp(t - m_safe), dim=3))
        # The host computes each side in LINEAR f64 (floored at e^log_min);
        # reproduce that floor so saturated sides agree exactly.
        return torch.clamp_min(torch.where(finite, out, log_min), log_min)

    lv = log_dot(lw_var)          # [W, 1, I]
    ln = log_dot(lw_novar)        # [W, V, I]
    return torch.where(has_reads[:, None, :], ln - lv, 0.0).sum(dim=2)


def infer_window_batch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                       has_reads, em_iters: int = 100):
    """Fused inference for one bucketed window batch (twin of
    likelihood_jax.infer_window_batch, same shapes and outputs):
    loglik [W, Hmax, Rmax] f32, sample_onehot [W, I, Rmax] f32,
    hap_mask [W, Hmax] bool, h1/h2 [G] genotype hap pairs,
    var_hap_mask [W, Vmax, Hmax] bool, has_reads [W, I] bool ->
    (lik [W, I, G], em_resp [W, I, G], freq [W, Hmax], gof_sum [W, I, G],
    ratios [W, Vmax], gl_rel [W, I, G], em_margin [W])."""
    _require_full_f32_matmul()
    h1 = h1.long()
    h2 = h2.long()
    Hmax = hap_mask.shape[1]
    n_ind = sample_onehot.shape[1]
    tol = min(1e-3, 1.0 / (n_ind * 4))  # reference eps, cpopulation.pyx:705

    gm = hap_mask[:, h1] & hap_mask[:, h2]                          # [W, G]
    gl, gof = genotype_gl_gof(loglik, h1, h2, sample_onehot)
    lik = rescale_likelihoods(gl, gm, has_reads)
    # Downstream runs in log space: the host path's relative likelihoods
    # and EM frequencies span far below the f32 LINEAR range.
    gmb = gm[:, None, :]
    neg = torch.where(gmb, gl, _NEG_INF)
    mx = torch.amax(neg, dim=2, keepdim=True)
    gl_rel = torch.clamp_min(gl - torch.where(torch.isfinite(mx), mx, 0.0),
                             -690.77552)
    gl_rel = torch.where(gmb, gl_rel, _NEG_INF)
    gl_rel = torch.where(has_reads[:, :, None], gl_rel,
                         torch.where(gmb, 0.0, _NEG_INF).to(gl_rel.dtype))
    log_freq, em, em_margin = em_frequencies_log(
        gl_rel, h1, h2, Hmax, hap_mask, has_reads, em_iters, tol=tol)
    freq = torch.exp(log_freq)
    ratios = variant_posterior_logratio(gl_rel, log_freq, var_hap_mask,
                                        h1, h2, has_reads)
    return lik, em, freq, gof, ratios, gl_rel, em_margin
