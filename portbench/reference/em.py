"""The plain fused window inference: a frozen copy of the port's plain
version of K3 (platypus_tpu_torch/ops/likelihood_torch.py
infer_window_batch and the functions it calls, at the commit that added
this benchmark), in plain torch, in the dtype of its float inputs.  It
imports nothing of the program.

Per window: genotype log-likelihoods and goodness of fit over the reads
of each individual, the relative log likelihoods, a log-domain EM over
haplotype frequencies that stops each window once its largest linear
change is at most tol = min(1e-3, 1 / (4 I)), and each variant's
posterior log ratio.
"""

from __future__ import annotations

import torch

LOG_HALF = -0.69314718055994529
LOG10E = 0.43429448190325182
LOG2 = 0.6931471805599453
GL_FLOOR = -690.77552
NEG_INF = float("-inf")


def _per_read_genotype(loglik, h1, h2):
    l1, l2 = loglik[:, h1], loglik[:, h2]
    same = (h1 == h2)[None, :, None]
    diff = torch.abs(l1 - l2)
    mx = torch.maximum(l1, l2)
    exact = mx + torch.log1p(torch.exp(-diff)) + LOG_HALF
    per_read = torch.where(same, l1, torch.where(
        diff >= 3.0, LOG_HALF + mx, torch.where(diff <= 1e-3, l1, exact)))
    return per_read, mx


def _gl_gof(loglik, h1, h2, sample_onehot):
    per_read, mx = _per_read_genotype(loglik, h1, h2)
    oh_t = sample_onehot.transpose(1, 2)
    return (torch.matmul(per_read, oh_t).transpose(1, 2),
            torch.matmul(LOG10E * mx, oh_t).transpose(1, 2))


def _rescale(gl, geno_mask, has_reads):
    gm = geno_mask[:, None, :]
    mx = torch.amax(torch.where(gm, gl, NEG_INF), dim=2, keepdim=True)
    lik = torch.where(gm, torch.clamp_min(torch.exp(gl - mx), 1e-300), 0.0)
    return torch.where(has_reads[:, :, None], lik,
                       torch.where(gm, 1.0, 0.0).to(lik.dtype))


def _lse(x, dim, keepdim: bool = False):
    m = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    out = m_safe + torch.log(torch.sum(torch.exp(x - m_safe), dim=dim,
                                       keepdim=True))
    out = torch.where(finite, out, NEG_INF)
    return out if keepdim else out.squeeze(dim)


def _em_log(log_lik, h1, h2, n_haps_max, hap_mask, has_reads, n_iters, tol):
    dt = log_lik.dtype
    log_het = torch.where(h1 != h2, LOG2, 0.0).to(dt)
    ll = torch.where(has_reads[:, :, None], log_lik, NEG_INF)
    n_haps = hap_mask.sum(dim=1).clamp_min(1)
    n_with_data = has_reads.sum(dim=1).clamp_min(1)
    log_freq = torch.where(hap_mask, -torch.log(n_haps.to(dt))[:, None],
                           NEG_INF)
    counts = (torch.nn.functional.one_hot(h1.long(), n_haps_max)
              + torch.nn.functional.one_hot(h2.long(), n_haps_max)).to(dt)
    logA = torch.where(counts > 0, torch.log(torch.clamp_min(counts, 1e-30)),
                       NEG_INF)
    log_denom = torch.log(2.0 * n_with_data.to(dt))
    w = torch.full_like(ll, NEG_INF)
    margin = torch.full(log_lik.shape[:1], float("inf"), dtype=dt,
                        device=log_lik.device)
    done = torch.zeros(log_lik.shape[:1], dtype=torch.bool,
                       device=log_lik.device)
    for _ in range(n_iters):
        log_w = ll + (log_freq[:, h1] + log_freq[:, h2] + log_het)[:, None, :]
        log_s = _lse(log_w, 2, keepdim=True)
        new_w = torch.where(torch.isfinite(log_s), log_w - log_s, NEG_INF)
        log_resp = _lse(new_w, 1)
        new = _lse(log_resp[:, :, None] + logA[None], 1) - log_denom[:, None]
        new = torch.where(hap_mask, new, NEG_INF)
        max_change = torch.amax(torch.abs(torch.exp(new) - torch.exp(log_freq)),
                                dim=1)
        active = ~done
        margin = torch.where(active, torch.minimum(
            margin, torch.abs(max_change - tol)), margin)
        log_freq = torch.where(active[:, None], new, log_freq)
        w = torch.where(active[:, None, None], new_w, w)
        done = done | (max_change <= tol)
    return log_freq, torch.where(has_reads[:, :, None], torch.exp(w), 0.0), margin


def _log_ratio(gl_rel, log_freq, hap_has_variant, h1, h2, has_reads):
    log_fp = torch.where(hap_has_variant, NEG_INF, log_freq[:, None, :])
    log_s = _lse(log_fp, 2, keepdim=True)
    log_fp = torch.where(torch.isfinite(log_s), log_fp - log_s, log_fp)
    log_het = torch.where(h1 != h2, LOG2, 0.0).to(gl_rel.dtype)
    lw_var = (log_het + log_freq[:, h1] + log_freq[:, h2])[:, None, :]
    lw_novar = log_het + log_fp[:, :, h1] + log_fp[:, :, h2]
    log_min = -708.0

    def log_dot(lw):
        t = lw[:, :, None, :] + gl_rel[:, None, :, :]
        m = torch.amax(t, dim=3, keepdim=True)
        finite = torch.isfinite(m[..., 0])
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        out = m_safe[..., 0] + torch.log(torch.sum(torch.exp(t - m_safe), dim=3))
        return torch.clamp_min(torch.where(finite, out, log_min), log_min)

    return torch.where(has_reads[:, None, :],
                       log_dot(lw_novar) - log_dot(lw_var), 0.0).sum(dim=2)


def infer_window_batch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                       has_reads, em_iters: int = 100):
    """loglik [W, H, R], sample_onehot [W, I, R] (float, one dtype),
    hap_mask [W, H], h1/h2 [G], var_hap_mask [W, V, H], has_reads [W, I]
    -> (lik, em, freq, gof, ratios, gl_rel, em_margin) in that dtype.
    Matrix products run at the dtype's full precision (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    h1, h2 = h1.long(), h2.long()
    Hmax = hap_mask.shape[1]
    tol = min(1e-3, 1.0 / (sample_onehot.shape[1] * 4))
    gm = hap_mask[:, h1] & hap_mask[:, h2]
    gl, gof = _gl_gof(loglik, h1, h2, sample_onehot)
    lik = _rescale(gl, gm, has_reads)
    gmb = gm[:, None, :]
    mx = torch.amax(torch.where(gmb, gl, NEG_INF), dim=2, keepdim=True)
    gl_rel = torch.clamp_min(gl - torch.where(torch.isfinite(mx), mx, 0.0),
                             GL_FLOOR)
    gl_rel = torch.where(gmb, gl_rel, NEG_INF)
    gl_rel = torch.where(has_reads[:, :, None], gl_rel,
                         torch.where(gmb, 0.0, NEG_INF).to(gl_rel.dtype))
    log_freq, em, em_margin = _em_log(gl_rel, h1, h2, Hmax, hap_mask,
                                      has_reads, em_iters, tol)
    ratios = _log_ratio(gl_rel, log_freq, var_hap_mask, h1, h2, has_reads)
    return lik, em, torch.exp(log_freq), gof, ratios, gl_rel, em_margin
