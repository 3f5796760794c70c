// Batched per-window variant-posterior log-ratios (the model-averaged
// segregation test of cpopulation.pyx:459-594, hoisted per window exactly
// like ops/likelihood.py::WindowPosteriorContext).
//
// Summation orders: the per-genotype dot products accumulate
// SEQUENTIALLY — the reference's own C loop order (cpopulation.pyx:542-
// 584) — where the numpy context uses BLAS np.dot; the two differ in the
// last ulp on some windows, and the emitted integer phred (PP/QUAL) is
// byte-checked against the running reference by the parity suite either
// way.  freqs_prime.sum() uses numpy's pairwise order (np_pairwise_sum)
// to match the host expression it replaces; log() is the shared libm.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "np_sum.h"

using ptpu::np_pairwise_sum;

namespace {

struct WindowSpec {
    const double* lik;      // [I, G] relative likelihoods
    const double* freq;     // [H]
    const int64_t* h1;      // [G]
    const int64_t* h2;      // [G]
    const int64_t* rows;    // [n_rows] individuals with data
    const uint8_t* var_in_hap;  // [V, H]
    double* ratios_out;     // [V]
    int32_t I, G, H, n_rows, V;
};

void posterior_window(const WindowSpec& w) {
    std::vector<double> w_var(w.G), w_novar(w.G), fp(w.H), log_pv(w.n_rows);
    // w_var = factor * freq[h1] * freq[h2]  (factor = 1 + (h1 != h2))
    for (int g = 0; g < w.G; ++g) {
        double f = (w.h1[g] != w.h2[g]) ? 2.0 : 1.0;
        w_var[g] = f * w.freq[w.h1[g]] * w.freq[w.h2[g]];
    }
    double sum_log_var = 0.0;
    for (int j = 0; j < w.n_rows; ++j) {
        const double* lrow = w.lik + (size_t)w.rows[j] * w.G;
        double pv = 0.0;
        for (int g = 0; g < w.G; ++g) pv += w_var[g] * lrow[g];
        log_pv[j] = pv > 0 ? std::log(pv) : -708.0;
        sum_log_var += log_pv[j];
    }
    for (int v = 0; v < w.V; ++v) {
        const uint8_t* has = w.var_in_hap + (size_t)v * w.H;
        for (int h = 0; h < w.H; ++h) fp[h] = has[h] ? 0.0 : w.freq[h];
        double s = np_pairwise_sum(fp.data(), w.H);
        if (s > 0) {
            for (int h = 0; h < w.H; ++h) fp[h] = fp[h] / s;
        }
        for (int g = 0; g < w.G; ++g) {
            double f = (w.h1[g] != w.h2[g]) ? 2.0 : 1.0;
            w_novar[g] = f * fp[w.h1[g]] * fp[w.h2[g]];
        }
        double sum_log_novar = 0.0;
        for (int j = 0; j < w.n_rows; ++j) {
            const double* lrow = w.lik + (size_t)w.rows[j] * w.G;
            double pn = 0.0;
            for (int g = 0; g < w.G; ++g) pn += w_novar[g] * lrow[g];
            sum_log_novar += pn > 0 ? std::log(pn) : -708.0;
        }
        w.ratios_out[v] = sum_log_novar - sum_log_var;
    }
}

}  // namespace

extern "C" {

// Single-window entry for the fused inference batch (infer.cpp).
void ptpu_posterior_window_one(const double* lik, const double* freq,
                               const int64_t* h1, const int64_t* h2,
                               const int64_t* rows, int32_t n_rows,
                               const uint8_t* var_in_hap, double* ratios_out,
                               int32_t I, int32_t G, int32_t H, int32_t V) {
    WindowSpec spec;
    spec.lik = lik;
    spec.freq = freq;
    spec.h1 = h1;
    spec.h2 = h2;
    spec.rows = rows;
    spec.var_in_hap = var_in_hap;
    spec.ratios_out = ratios_out;
    spec.I = I;
    spec.G = G;
    spec.H = H;
    spec.n_rows = n_rows;
    spec.V = V;
    posterior_window(spec);
}

// Flat-packed batch: window w's likelihoods start at lik_flat[lik_off[w]]
// ([I_arr[w], G_arr[w]]), frequencies at freq_flat[freq_off[w]], h1/h2 at
// h_off[w] in the shared tables, data-rows at rows_flat[rows_off[w]]
// (n_rows = rows_off[w+1]-rows_off[w]), variant membership masks at
// vih_flat[vih_off[w]] ([V_arr[w], H_arr[w]] uint8) and output ratios at
// ratio_off[w] ([V_arr[w]]).
void ptpu_posteriors_batch(
    const double* lik_flat, const int64_t* lik_off,
    const int32_t* I_arr, const int32_t* G_arr,
    const double* freq_flat, const int64_t* freq_off, const int32_t* H_arr,
    const int64_t* h1_flat, const int64_t* h2_flat, const int64_t* h_off,
    const int64_t* rows_flat, const int64_t* rows_off,
    const uint8_t* vih_flat, const int64_t* vih_off, const int32_t* V_arr,
    const int64_t* ratio_off, double* ratios_out,
    int32_t n_windows, int32_t n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            WindowSpec spec;
            spec.lik = lik_flat + lik_off[w];
            spec.freq = freq_flat + freq_off[w];
            spec.h1 = h1_flat + h_off[w];
            spec.h2 = h2_flat + h_off[w];
            spec.rows = rows_flat + rows_off[w];
            spec.var_in_hap = vih_flat + vih_off[w];
            spec.ratios_out = ratios_out + ratio_off[w];
            spec.I = I_arr[w];
            spec.G = G_arr[w];
            spec.H = H_arr[w];
            spec.n_rows = (int32_t)(rows_off[w + 1] - rows_off[w]);
            spec.V = V_arr[w];
            posterior_window(spec);
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > n_windows) nt = n_windows;
    if (nt <= 1) {
        run();
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(run);
    for (auto& th : threads) th.join();
}

}  // extern "C"
