// Per-sample genotype call + marginal likelihood classes, float64,
// bit-exact with the Python oracle
// (platypus_tpu_torch/vcfout/records.py::_compute_genotype_call_and_likelihoods_py,
// the reference's vcfutils.pyx:163-334 per-record hot loop).
//
// The computation is all +,*,max/min over a handful of [G] vectors, so
// IEEE double arithmetic reproduces numpy exactly provided the masked
// `base[match].sum()` uses numpy's pairwise order over the gathered
// subset (np_sum.h) and argmax keeps the first strict maximum.
// tests/test_native.py pins byte-exact equality against the oracle over
// randomized windows; the wrapper falls back to Python when the library
// is unavailable.

#include <cmath>
#include <cstdint>
#include <vector>

#include "np_sum.h"

extern "C" {

// lik: [G] relative likelihoods for ONE sample (row of [I, G]).
// freqs: [H] EM haplotype frequencies.
// h1/h2: [G] genotype haplotype-index pairs.
// hap_is_ref: [H] 0/1 — haplotype is reference at the emitted position.
// var_in_hap: [H, n_vars] row-major bool(u8).
// gof: goodness-of-fit matrix base pointer; this sample's column is
//      gof[g * gof_stride + gof_off] (avoids a per-call contiguous copy).
// Outputs: lik_out [(n_vars+1)(n_vars+2)/2] marginals in class order,
// phased_out [2] = (phased1, phased2), scalars_out [5] =
// (best_likelihood, non_ref_post, ref_post, sum_lik, best_gof).
void ptpu_genotype_call(
    const double* lik, const double* freqs,
    const int64_t* h1, const int64_t* h2, int64_t G,
    const int64_t* hap_is_ref,
    const uint8_t* var_in_hap, int64_t n_vars,
    const double* gof, int64_t gof_stride, int64_t gof_off,
    int32_t n_individuals,
    double* lik_out, int32_t* phased_out, double* scalars_out) {
    thread_local std::vector<double> base_buf, gather_buf;
    if ((int64_t)base_buf.size() < G) {
        base_buf.resize(G);
        gather_buf.resize(G);
    }
    double* base = base_buf.data();
    double* gathered = gather_buf.data();

    // base = factor * lik  (or factor * freqs[h1] * freqs[h2] * lik for
    // large cohorts), multiplied in the oracle's operand order.
    const bool use_freqs = n_individuals > 25;
    for (int64_t g = 0; g < G; ++g) {
        double t = (h1[g] != h2[g]) ? 2.0 : 1.0;
        if (use_freqs) {
            t = t * freqs[h1[g]];
            t = t * freqs[h2[g]];
        }
        base[g] = t * lik[g];
    }

    double best_likelihood = -1.0;
    double best_gof = 1e6;
    int32_t phased1 = -1, phased2 = -1;
    double phased_max = -1e6;
    double non_ref_post = 0.0, ref_post = 0.0, sum_lik = 0.0;
    int64_t out_idx = 0;

    for (int64_t index1 = 0; index1 <= n_vars; ++index1) {
        for (int64_t index2 = 0; index2 <= index1; ++index2) {
            // One fused pass over genotypes: match predicate, gather of
            // matched base values (for the numpy-order sum), first-strict
            // argmax over where(match, base, -inf), and matched gof min.
            int64_t n_match = 0;
            int64_t g_best = 0;
            double cur_best = -HUGE_VAL;
            double min_gof = HUGE_VAL;
            bool gof_nan = false;
            for (int64_t g = 0; g < G; ++g) {
                const int64_t a = h1[g], b = h2[g];
                bool match;
                if (index1 == 0) {
                    match = hap_is_ref[a] && hap_is_ref[b];
                } else if (index2 == 0) {
                    const uint8_t v1h1 = var_in_hap[a * n_vars + (index1 - 1)];
                    const uint8_t v1h2 = var_in_hap[b * n_vars + (index1 - 1)];
                    match = (hap_is_ref[b] && v1h1) || (hap_is_ref[a] && v1h2);
                } else {
                    const uint8_t v1h1 = var_in_hap[a * n_vars + (index1 - 1)];
                    const uint8_t v1h2 = var_in_hap[b * n_vars + (index1 - 1)];
                    const uint8_t v2h1 = var_in_hap[a * n_vars + (index2 - 1)];
                    const uint8_t v2h2 = var_in_hap[b * n_vars + (index2 - 1)];
                    match = (v1h1 && v2h2) || (v2h1 && v1h2);
                }
                if (match) {
                    gathered[n_match++] = base[g];
                    if (base[g] > cur_best) {
                        cur_best = base[g];
                        g_best = g;
                    }
                    const double gv = gof[g * gof_stride + gof_off];
                    if (std::isnan(gv)) gof_nan = true;
                    else if (gv < min_gof) min_gof = gv;
                }
            }

            double marginal = 0.0;
            if (n_match > 0) {
                marginal = ptpu::np_pairwise_sum(gathered, n_match);
                // numpy argmax over where(match, base, -inf): the first
                // strict max among matched genotypes — identical to the
                // in-loop tracking above because unmatched slots are -inf.
                if (cur_best > phased_max) {
                    phased_max = cur_best;
                    if (index1 == 0 && index2 == 0) {
                        phased1 = 0; phased2 = 0;
                    } else if (index2 == 0) {
                        if (var_in_hap[h1[g_best] * n_vars + (index1 - 1)]) {
                            phased1 = (int32_t)index1; phased2 = 0;
                        } else if (var_in_hap[h2[g_best] * n_vars + (index1 - 1)]) {
                            phased1 = 0; phased2 = (int32_t)index1;
                        }
                    } else if (index1 == index2) {
                        phased1 = (int32_t)index1; phased2 = (int32_t)index2;
                    } else {
                        if (var_in_hap[h1[g_best] * n_vars + (index1 - 1)] &&
                            var_in_hap[h2[g_best] * n_vars + (index2 - 1)]) {
                            phased1 = (int32_t)index1; phased2 = (int32_t)index2;
                        } else if (var_in_hap[h2[g_best] * n_vars + (index1 - 1)] &&
                                   var_in_hap[h1[g_best] * n_vars + (index2 - 1)]) {
                            phased1 = (int32_t)index2; phased2 = (int32_t)index1;
                        }
                    }
                }
                const double mg = gof_nan ? NAN : min_gof;
                if (mg < best_gof) best_gof = mg;
            }

            if (marginal > best_likelihood) best_likelihood = marginal;
            if (index1 == 1 && (index2 == 0 || index2 == 1)) {
                non_ref_post += marginal;
            } else if (index1 == 0 && index2 == 0) {
                ref_post += marginal;
            }
            sum_lik += marginal;
            lik_out[out_idx++] = marginal;
        }
    }

    phased_out[0] = phased1;
    phased_out[1] = phased2;
    scalars_out[0] = best_likelihood;
    scalars_out[1] = non_ref_post;
    scalars_out[2] = ref_post;
    scalars_out[3] = sum_lik;
    scalars_out[4] = best_gof;
}

}  // extern "C"
