// Haplotype-frequency EM, float64, bit-exact with the numpy oracle
// (platypus_tpu_torch/ops/likelihood.py::em_haplotype_frequencies — the
// reference's cpopulation.pyx:384-457,678-716 hot loop #2 on host).
//
// The EM uses only +, *, / (no transcendentals), so IEEE-754 double
// arithmetic reproduces numpy EXACTLY provided the summation ORDER
// matches.  numpy reduces the fast (contiguous) axis with pairwise
// summation (8-way partials, block 128, halving recursion) and the outer
// axis sequentially row-by-row; np.add.at scatters sequentially.  The
// helpers below mirror those orders; tests/test_native.py pins byte-exact
// equality against the numpy oracle over randomized shapes, and any
// divergence makes the wrapper fall back to numpy.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "np_sum.h"

using ptpu::np_pairwise_sum;

static int em_f64_one(const double* lik, int nd, int G,
                      const int64_t* h1, const int64_t* h2, int n_haps,
                      double eps, int max_iters,
                      double* freq_out, double* w_out);

extern "C" {

// lik: [nd, G] row-major, only individuals WITH data.
// h1/h2: [G] haplotype index pairs.  het[g] implied by h1[g] != h2[g].
// Outputs: freq_out [n_haps], w_out [nd, G] (EM responsibilities of the
// final iteration), returns the iteration count (<= max_iters); -1 on
// bad arguments.
int ptpu_em_f64(const double* lik, int nd, int G,
                const int64_t* h1, const int64_t* h2, int n_haps,
                double eps, int max_iters,
                double* freq_out, double* w_out) {
    return em_f64_one(lik, nd, G, h1, h2, n_haps, eps, max_iters,
                      freq_out, w_out);
}

// Batched EM over a region's independent windows in ONE native call
// (the reference runs its EM as compiled C per window inside
// callVariantsInWindow, cpopulation.pyx:678-716; this is the batched
// equivalent).  Window w's likelihoods are lik_flat[lik_off[w] ..] as an
// [nd_arr[w], G_arr[w]] row-major block; h1/h2 index pairs live at
// h_off[w] in the shared flat tables; frequencies land at freq_off[w].
// w_out shares lik_flat's layout.  Windows are independent, so they run
// on a small thread pool; arithmetic is em_f64_one per window,
// bit-identical to the single-window entry.
void ptpu_em_f64_batch(const double* lik_flat, const int64_t* lik_off,
                       const int32_t* nd_arr, const int32_t* G_arr,
                       const int64_t* h1_flat, const int64_t* h2_flat,
                       const int64_t* h_off, const int32_t* H_arr,
                       const int64_t* freq_off, int n_windows,
                       const double* eps_arr, int max_iters,
                       double* freq_out, double* w_out, int32_t* iters_out,
                       int n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            iters_out[w] = em_f64_one(
                lik_flat + lik_off[w], nd_arr[w], G_arr[w],
                h1_flat + h_off[w], h2_flat + h_off[w], H_arr[w],
                eps_arr[w], max_iters,
                freq_out + freq_off[w], w_out + lik_off[w]);
        }
    };
    int nt = n_threads;
    if (nt < 1) nt = 1;
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

static int em_f64_one(const double* lik, int nd, int G,
                      const int64_t* h1, const int64_t* h2, int n_haps,
                      double eps, int max_iters,
                      double* freq_out, double* w_out) {
    if (nd <= 0 || G <= 0 || n_haps <= 0) return -1;
    std::vector<double> gw(G), resp(G), new_freq(n_haps);
    std::vector<double> freq(n_haps, 1.0 / n_haps);
    const double denom = 2.0 * nd;
    int iters = 0;
    while (iters < max_iters) {
        // gw[g] = freq[h1]*freq[h2]*het  (elementwise, same op order as
        // numpy's freq[h1_idx] * freq[h2_idx] * het_factor)
        for (int g = 0; g < G; ++g) {
            double t = freq[h1[g]] * freq[h2[g]];
            gw[g] = (h1[g] != h2[g]) ? t * 2.0 : t * 1.0;
        }
        // w = lik * gw; s = w.sum(axis=1) (pairwise, fast axis);
        // w /= s where s > 0 else 0
        for (int i = 0; i < nd; ++i) {
            double* wrow = w_out + (size_t)i * G;
            const double* lrow = lik + (size_t)i * G;
            for (int g = 0; g < G; ++g) wrow[g] = lrow[g] * gw[g];
            double s = np_pairwise_sum(wrow, G);
            if (s > 0) {
                for (int g = 0; g < G; ++g) wrow[g] = wrow[g] / s;
            } else {
                for (int g = 0; g < G; ++g) wrow[g] = 0.0;
            }
        }
        // resp = w.sum(axis=0): outer-axis reduction, sequential rows.
        std::memcpy(resp.data(), w_out, sizeof(double) * G);
        for (int i = 1; i < nd; ++i) {
            const double* wrow = w_out + (size_t)i * G;
            for (int g = 0; g < G; ++g) resp[g] += wrow[g];
        }
        // np.add.at(new_freq, h1, resp); np.add.at(new_freq, h2, resp)
        std::memset(new_freq.data(), 0, sizeof(double) * n_haps);
        for (int g = 0; g < G; ++g) new_freq[h1[g]] += resp[g];
        for (int g = 0; g < G; ++g) new_freq[h2[g]] += resp[g];
        for (int h = 0; h < n_haps; ++h) new_freq[h] = new_freq[h] / denom;
        double max_change = 0.0;
        for (int h = 0; h < n_haps; ++h) {
            double d = freq[h] - new_freq[h];
            if (d < 0) d = -d;
            if (d > max_change) max_change = d;
        }
        freq.assign(new_freq.begin(), new_freq.end());
        ++iters;
        if (max_change <= eps) break;
    }
    std::memcpy(freq_out, freq.data(), sizeof(double) * n_haps);
    return iters;
}
