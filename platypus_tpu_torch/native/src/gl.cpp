// Batched genotype log-likelihoods + rescale, replicating the reference's
// SEQUENTIAL per-read accumulation exactly (cgenotype.pyx:131-189 and the
// rescale of cpopulation.pyx:283-309): per (individual, genotype), reads
// accumulate in row order (good, bad, broken per sample — the engine's
// window row order) with the three fast paths, scalar libm log/exp for
// the exact-mixture case, then lik = max(1e-300, exp(gl - max_g gl)).
//
// The numpy twin (ops/likelihood.py::genotype_log_likelihoods_segments)
// sums with numpy's pairwise order; on near-symmetric windows the two
// differ in the last ulp and the emitted genotype phase flips — the S55
// "dense" corpus hit one.  The reference order is the byte contract, so
// this kernel is the production path and the numpy twin the fallback.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

constexpr double kLog10E = 0.43429448190325182;
constexpr double kLogHalf = -0.69314718055994529;

// One window: ll [H, R] row-major; bounds [I+1] sample row ranges;
// h1/h2 [G].  Outputs gl/gof_sum/lik all [I, G] row-major.
// (extern so the fused inference batch in infer.cpp reuses it.)
extern "C" void ptpu_gl_window_one(const double* ll, int32_t H, int32_t R,
               const int64_t* bounds, const int64_t* n_good, int32_t I,
               const int64_t* h1, const int64_t* h2, int32_t G,
               double* gl, double* gof, double* lik) {
    (void)H;
    for (int32_t i = 0; i < I; ++i) {
        const int64_t lo = bounds[i], hi = bounds[i + 1];
        double max_ll = -1e7;
        for (int32_t g = 0; g < G; ++g) {
            const double* arr1 = ll + h1[g] * (int64_t)R;
            const double* arr2 = ll + h2[g] * (int64_t)R;
            double likelihood = 0.0;
            double gofv = 0.0;
            if (arr1 == arr2) {
                for (int64_t r = lo; r < hi; ++r) {
                    likelihood += arr1[r];
                    gofv += kLog10E * arr1[r];
                }
            } else {
                for (int64_t r = lo; r < hi; ++r) {
                    const double like1 = arr1[r];
                    const double like2 = arr2[r];
                    const double l10a = kLog10E * like1;
                    const double l10b = kLog10E * like2;
                    gofv += (l10a > l10b) ? l10a : l10b;
                    const double d = std::fabs(like1 - like2);
                    if (d >= 3.0) {
                        likelihood +=
                            kLogHalf + ((like1 > like2) ? like1 : like2);
                    } else if (d <= 1e-3) {
                        likelihood += like1;
                    } else {
                        likelihood +=
                            std::log(0.5 * (std::exp(like1) + std::exp(like2)));
                    }
                }
            }
            gl[(size_t)i * G + g] = likelihood;
            gof[(size_t)i * G + g] = gofv;
            if (likelihood > max_ll) max_ll = likelihood;
        }
        // Rescale (cpopulation.pyx:304-309): relative likelihoods for
        // individuals WITH good reads, all-1.0 otherwise.  gl for no-read
        // individuals is zeroed to match the host path's emitted table.
        if (n_good[i] > 0) {
            for (int32_t g = 0; g < G; ++g) {
                double v = std::exp(gl[(size_t)i * G + g] - max_ll);
                lik[(size_t)i * G + g] = (v > 1e-300) ? v : 1e-300;
            }
        } else {
            for (int32_t g = 0; g < G; ++g) {
                gl[(size_t)i * G + g] = 0.0;
                lik[(size_t)i * G + g] = 1.0;
            }
        }
    }
}

extern "C" {

// Flat-packed batch over a region's windows, threaded.  Window w's
// loglik block starts at ll_flat[ll_off[w]] ([H_arr[w], R_arr[w]]);
// bounds at w*(I+1) of bounds_flat; n_good at w*I; h1/h2 at h_off[w]
// (G_arr[w] pairs); outputs at out_off[w] ([I, G_arr[w]] each).
void ptpu_gl_batch(const double* ll_flat, const int64_t* ll_off,
                   const int32_t* H_arr, const int32_t* R_arr,
                   const int64_t* bounds_flat, const int64_t* n_good_flat,
                   int32_t I,
                   const int64_t* h1_flat, const int64_t* h2_flat,
                   const int64_t* h_off, const int32_t* G_arr,
                   const int64_t* out_off, int32_t n_windows,
                   double* gl_out, double* gof_out, double* lik_out,
                   int32_t n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            ptpu_gl_window_one(ll_flat + ll_off[w], H_arr[w], R_arr[w],
                      bounds_flat + (size_t)w * (I + 1),
                      n_good_flat + (size_t)w * I, I,
                      h1_flat + h_off[w], h2_flat + h_off[w], G_arr[w],
                      gl_out + out_off[w], gof_out + out_off[w],
                      lik_out + out_off[w]);
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

// Batched pair-score -> [H, R] log-likelihood conversion (engine/score.py
// ::window_loglik_from_pair_scores semantics): scatter-min the pair
// scores into the (hap, aligned-read) table (INT32_MAX init, short reads
// 0), then loglik = max(-300, MLTOT*score + term[a]) at align_rows
// columns, 0 elsewhere.  term[a] = ln(1 - 10^(-mapq/10)) is precomputed
// by the caller with the SAME numpy elementwise ops as the fallback, so
// the C side is pure mul/add/max — exact IEEE replication.  Pointer
// tables into the live request arrays; threaded across windows.
void ptpu_loglik_batch(const uint64_t* ps_ptrs, const uint64_t* ph_ptrs,
                       const uint64_t* pr_ptrs, const uint64_t* sublen_ptrs,
                       const uint64_t* term_ptrs, const uint64_t* rows_ptrs,
                       const uint64_t* out_ptrs,
                       const int32_t* P_arr, const int32_t* A_arr,
                       const int32_t* H_arr, const int32_t* R_arr,
                       int32_t hash_nucs, double mltot,
                       int32_t n_windows, int32_t n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        std::vector<int64_t> scores;
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            const int32_t P = P_arr[w], A = A_arr[w], H = H_arr[w],
                          R = R_arr[w];
            const int64_t* ps = reinterpret_cast<const int64_t*>(ps_ptrs[w]);
            const int64_t* ph = reinterpret_cast<const int64_t*>(ph_ptrs[w]);
            const int64_t* pr = reinterpret_cast<const int64_t*>(pr_ptrs[w]);
            const int32_t* sl =
                reinterpret_cast<const int32_t*>(sublen_ptrs[w]);
            const double* term =
                reinterpret_cast<const double*>(term_ptrs[w]);
            const int64_t* rows =
                reinterpret_cast<const int64_t*>(rows_ptrs[w]);
            double* out = reinterpret_cast<double*>(out_ptrs[w]);
            scores.assign((size_t)H * A, 0);
            if (P > 0) {
                for (size_t k = 0; k < scores.size(); ++k)
                    scores[k] = INT32_MAX;
                for (int32_t a = 0; a < A; ++a)
                    if (sl[a] < hash_nucs)
                        for (int32_t h = 0; h < H; ++h)
                            scores[(size_t)h * A + a] = 0;
                for (int32_t p = 0; p < P; ++p) {
                    int64_t& slot = scores[(size_t)ph[p] * A + pr[p]];
                    if (ps[p] < slot) slot = ps[p];
                }
            }
            for (size_t k = 0; k < (size_t)H * R; ++k) out[k] = 0.0;
            for (int32_t h = 0; h < H; ++h) {
                for (int32_t a = 0; a < A; ++a) {
                    double v = mltot * (double)scores[(size_t)h * A + a]
                               + term[a];
                    if (!(v > -300.0)) v = -300.0;
                    out[(size_t)h * R + rows[a]] = v;
                }
            }
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
