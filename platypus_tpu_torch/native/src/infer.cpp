// Fused per-region inference batch: for every window, GL (sequential
// reference accumulation, gl.cpp) -> GOF division -> rescale -> genotype
// argmax -> haplotype-frequency EM (em.cpp) -> variant-posterior ratios
// (posterior.cpp), all in ONE threaded native call.  Each arithmetic
// stage is the already-verified single-window kernel; this file only
// orchestrates, so results are bit-identical to calling the stage
// batches separately (pinned by tests/test_native.py and the e2e byte
// parity suite).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

void ptpu_gl_window_one(const double* ll, int32_t H, int32_t R,
                        const int64_t* bounds, const int64_t* n_good,
                        int32_t I, const int64_t* h1, const int64_t* h2,
                        int32_t G, double* gl, double* gof, double* lik);

int ptpu_em_f64(const double* lik, int nd, int G,
                const int64_t* h1, const int64_t* h2, int n_haps,
                double eps, int max_iters,
                double* freq_out, double* w_out);

void ptpu_posterior_window_one(const double* lik, const double* freq,
                               const int64_t* h1, const int64_t* h2,
                               const int64_t* rows, int32_t n_rows,
                               const uint8_t* var_in_hap, double* ratios_out,
                               int32_t I, int32_t G, int32_t H, int32_t V);

// Layouts (per window w):
//   ll_flat[ll_off[w]]        [H_arr[w], R_arr[w]] loglik
//   bounds_flat[w*(I+1)]      sample row bounds
//   n_good_flat[w*I]          good-read counts
//   h1/h2_flat[h_off[w]]      G_arr[w] genotype index pairs
//   vih_flat[vih_off[w]]      [V_arr[w], H_arr[w]] variant membership
//   outputs: gl/gof_div/lik/csr at out_off[w] ([I, G]; gof_div is the
//   DIVIDED [G, I] table finish_window consumes), freq at freq_off[w]
//   ([H]), argmax at w*I (-1 = no data), iters at w, ratios at
//   ratio_off[w] ([V]).
void ptpu_infer_batch(
    const double* ll_flat, const int64_t* ll_off,
    const int32_t* H_arr, const int32_t* R_arr,
    const int64_t* bounds_flat, const int64_t* n_good_flat, int32_t I,
    const int64_t* h1_flat, const int64_t* h2_flat, const int64_t* h_off,
    const int32_t* G_arr,
    const uint8_t* vih_flat, const int64_t* vih_off, const int32_t* V_arr,
    const double* eps_arr, int32_t max_iters,
    const int64_t* out_off, const int64_t* freq_off,
    const int64_t* ratio_off, int32_t n_windows,
    double* gl_out, double* gof_div_out, double* lik_out,
    double* freq_out, double* csr_out, int32_t* iters_out,
    int32_t* argmax_out, double* ratios_out, int32_t n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        std::vector<double> gof_raw, nd_lik, w_resp;
        std::vector<int64_t> rows;
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            const int32_t H = H_arr[w], R = R_arr[w], G = G_arr[w],
                          V = V_arr[w];
            const int64_t* bounds = bounds_flat + (size_t)w * (I + 1);
            const int64_t* n_good = n_good_flat + (size_t)w * I;
            const int64_t* h1 = h1_flat + h_off[w];
            const int64_t* h2 = h2_flat + h_off[w];
            double* gl = gl_out + out_off[w];
            double* gof_div = gof_div_out + out_off[w];
            double* lik = lik_out + out_off[w];
            double* csr = csr_out + out_off[w];
            double* freq = freq_out + freq_off[w];
            int32_t* argmax = argmax_out + (size_t)w * I;

            // GL + rescale (gof_raw holds the per-(i, g) SUMS first).
            gof_raw.assign((size_t)I * G, 0.0);
            ptpu_gl_window_one(ll_flat + ll_off[w], H, R, bounds, n_good, I,
                               h1, h2, G, gl, gof_raw.data(), lik);

            // GOF division into the [G, I] layout finish_window consumes:
            // gof_div[g, i] = (-10 * gof_raw[i, g]) / n_good[i], 0 for
            // no-data individuals (numpy's elementwise order replicated).
            rows.clear();
            for (int32_t i = 0; i < I; ++i) {
                if (n_good[i] > 0) {
                    rows.push_back(i);
                    const double inv = (double)n_good[i];
                    for (int32_t g = 0; g < G; ++g)
                        gof_div[(size_t)g * I + i] =
                            (-10.0 * gof_raw[(size_t)i * G + g]) / inv;
                } else {
                    for (int32_t g = 0; g < G; ++g)
                        gof_div[(size_t)g * I + i] = 0.0;
                }
            }

            // Genotype argmax per individual (first strict maximum).
            for (int32_t i = 0; i < I; ++i) {
                if (n_good[i] <= 0) {
                    argmax[i] = -1;
                    continue;
                }
                const double* row = lik + (size_t)i * G;
                int32_t best = 0;
                for (int32_t g = 1; g < G; ++g)
                    if (row[g] > row[best]) best = g;
                argmax[i] = best;
            }

            // EM over the data rows (contiguous gather, em.cpp kernel).
            const int32_t nd = (int32_t)rows.size();
            for (size_t k = 0; k < (size_t)I * G; ++k) csr[k] = 0.0;
            if (nd == 0) {
                for (int32_t h = 0; h < H; ++h) freq[h] = 1.0 / H;
                iters_out[w] = 0;
            } else {
                nd_lik.resize((size_t)nd * G);
                w_resp.resize((size_t)nd * G);
                for (int32_t k = 0; k < nd; ++k)
                    std::memcpy(nd_lik.data() + (size_t)k * G,
                                lik + (size_t)rows[k] * G,
                                sizeof(double) * G);
                iters_out[w] = ptpu_em_f64(nd_lik.data(), nd, G, h1, h2, H,
                                           eps_arr[w], max_iters, freq,
                                           w_resp.data());
                for (int32_t k = 0; k < nd; ++k)
                    std::memcpy(csr + (size_t)rows[k] * G,
                                w_resp.data() + (size_t)k * G,
                                sizeof(double) * G);
            }

            // Variant posteriors from the fresh frequencies.
            if (V > 0)
                ptpu_posterior_window_one(
                    lik, freq, h1, h2, rows.data(), nd,
                    vih_flat + vih_off[w], ratios_out + ratio_off[w],
                    I, G, H, V);
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
