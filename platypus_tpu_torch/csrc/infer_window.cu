// Fused per-window inference for NVIDIA Hopper (sm_90a): genotype GL/GOF,
// rescale, relative log GLs, log-domain EM and posterior log ratios.
//
// Replaces platypus_tpu/ops/likelihood_jax.py::infer_window_batch (an XLA
// program, not a Pallas kernel: one jit program per bucket shape whose EM
// is a vmapped lax.while_loop).  Same contract as the plain torch version,
// platypus_tpu_torch/ops/likelihood_torch.py::infer_window_batch, on the
// same inputs and with the same seven outputs (lik, em, freq, gof, ratios,
// gl_rel, em_margin), all float32.  The plain version runs 100 masked EM
// iterations for every window in ~35 aten ops each; here one CTA runs a
// window's EM and leaves it after the iteration at which the reference's
// linear max-change test passes, which is what the vmapped while_loop's
// freeze leaves.
//
// Two kernels, launched by ptt_infer_window_batch on the caller's stream:
// * infer_window_gl_kernel, gridded over (window, tile of 8 genotypes),
//   one warp per genotype and its lanes over reads: the per-read genotype
//   log-likelihood with the reference's fast paths (same hap; diff >= 3;
//   diff <= 1e-3; log1p(exp(-diff))) and max(l1, l2), contracted with
//   sample_onehot in f32 FMAs (gl[i,g] = sum_r per_read * onehot[i,r],
//   gof[i,g] = sum_r LOG10E * max * onehot[i,r]).  It writes gl into the
//   lik output, which the second kernel reads and overwrites.
// * infer_window_em_kernel, one CTA of 256 threads per window: lik and
//   gl_rel from gl, the EM, freq, and the [V] posterior log ratios.  The
//   M-step's logsumexp over logA[g, h] is a per-hap sum over the H
//   genotypes that hold hap h, found from the lexicographic pair order
//   (g(i, j) = i*H - i*(i-1)/2 + j - i for i <= j), plus ln 2 for the
//   homozygous one.  The kernel checks h1/h2 against that order first and
//   writes NaN into every output of a window if they differ.
//
// Memory: a window's tables -- gl_rel and the log responsibilities [I, G],
// log_resp [G], log_freq and the next log_freq [H], the variant side's
// per-individual log sums [I] -- sit in dynamic shared memory while they
// fit (the wrapper, ops/likelihood_cuda.py em_table_bytes, decides from
// the byte count, 227 KB at most); beyond that the same code runs on a
// global workspace of the same layout (the template argument kGlobal).
//
// What bounds it: not the bytes (a batch moves well under a megabyte) and
// not the card's transcendental rate, but the EM's chain of dependent
// block-wide steps: each iteration is four barrier-separated passes
// (E-step rows, log_resp, M-step, max change) over tables that are small
// for the slice's windows.  The design keeps every table on the SM, runs
// rows over warps with shuffle reductions, and stops each window at its
// own convergence.
//
// Determinism: no atomics; every reduction has a fixed order (per-lane
// sums in index order, then an xor butterfly, which leaves the same value
// in every lane), so two launches give the same bits.  expf, logf and
// log1pf are the accurate library functions (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogHalf = -0.69314718055994529f;
constexpr float kLog10E = 0.43429448190325182f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kGlFloor = -690.77552f;   // ln 1e-300
constexpr float kLogMin = -708.0f;
constexpr int kGlWarps = 8;               // genotypes per GL block
constexpr int kGlChunk = 8;               // individuals per pass over reads
constexpr int kEmThreads = 256;
constexpr int kEmWarps = kEmThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* loglik;      // [W, H, R]
  const float* onehot;      // [W, I, R]
  const uint8_t* hap_mask;  // [W, H]
  const int32_t* h1;        // [G]
  const int32_t* h2;        // [G]
  const uint8_t* var_mask;  // [W, V, H]
  const uint8_t* has_reads; // [W, I]
  float* lik;               // [W, I, G]; the GL kernel's gl first
  float* em;                // [W, I, G]
  float* freq;              // [W, H]
  float* gof;               // [W, I, G]
  float* ratios;            // [W, V]
  float* gl_rel;            // [W, I, G]
  float* margin;            // [W]
  int32_t* iters;           // [W] EM iterations run
  float* workspace;         // [W, table_floats] on the global path, else null
  int W, H, R, I, V, G, em_iters;
  float tol;
};

__host__ __device__ inline size_t table_floats(int H, int I) {
  const size_t G = (size_t)H * (H + 1) / 2;
  return 2 * (size_t)I * G + G + 2 * (size_t)H + I;
}

__device__ __forceinline__ int pair_index(int i, int j, int H) {
  return i * H - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The masked logsumexp's end: m is the max, s the sum of exp(x - m_safe).
__device__ __forceinline__ float lse_finish(float m, float s) {
  return isfinite(m) ? m + logf(s) : -INFINITY;
}

__device__ __forceinline__ float safe(float m) {
  return isfinite(m) ? m : 0.0f;
}

__global__ void __launch_bounds__(kGlWarps * 32)
infer_window_gl_kernel(Args a, int tiles) {
  const int w = blockIdx.x / tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = (blockIdx.x % tiles) * kGlWarps + warp;
  if (g >= a.G) return;
  const int p = a.h1[g], q = a.h2[g];
  const int R = a.R, I = a.I;
  const float* l1p = a.loglik + ((size_t)w * a.H + p) * R;
  const float* l2p = a.loglik + ((size_t)w * a.H + q) * R;
  const float* oh = a.onehot + (size_t)w * I * R;
  for (int i0 = 0; i0 < I; i0 += kGlChunk) {
    float acc_gl[kGlChunk], acc_gof[kGlChunk];
#pragma unroll
    for (int k = 0; k < kGlChunk; ++k) acc_gl[k] = acc_gof[k] = 0.0f;
    for (int r = lane; r < R; r += 32) {
      const float l1 = __ldg(l1p + r), l2 = __ldg(l2p + r);
      const float diff = fabsf(l1 - l2);
      const float mx = fmaxf(l1, l2);
      float pr;
      if (p == q || diff <= 1e-3f) {
        pr = l1;
      } else if (diff >= 3.0f) {
        pr = kLogHalf + mx;
      } else {
        pr = (mx + log1pf(expf(-diff))) + kLogHalf;
      }
      const float gv = kLog10E * mx;
#pragma unroll
      for (int k = 0; k < kGlChunk; ++k) {
        if (i0 + k < I) {
          const float o = __ldg(oh + (size_t)(i0 + k) * R + r);
          acc_gl[k] = fmaf(pr, o, acc_gl[k]);
          acc_gof[k] = fmaf(gv, o, acc_gof[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGlChunk; ++k) {
      const float sg = warp_sum(acc_gl[k]);
      const float sf = warp_sum(acc_gof[k]);
      if (lane == 0 && i0 + k < I) {
        const size_t at = ((size_t)w * I + i0 + k) * a.G + g;
        a.lik[at] = sg;
        a.gof[at] = sf;
      }
    }
  }
}

// NaN into every output of window w (its h1/h2 are not the lexicographic
// pairs of H, which the M-step relies on).
__device__ void poison_window(const Args& a, int w) {
  const float nan = __int_as_float(0x7fc00000);
  const size_t IG = (size_t)a.I * a.G, base = (size_t)w * IG;
  for (size_t k = threadIdx.x; k < IG; k += kEmThreads) {
    a.lik[base + k] = a.em[base + k] = a.gof[base + k] = nan;
    a.gl_rel[base + k] = nan;
  }
  for (int h = threadIdx.x; h < a.H; h += kEmThreads) a.freq[(size_t)w * a.H + h] = nan;
  for (int v = threadIdx.x; v < a.V; v += kEmThreads) a.ratios[(size_t)w * a.V + v] = nan;
  if (threadIdx.x == 0) {
    a.margin[w] = nan;
    a.iters[w] = -1;
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kEmThreads)
infer_window_em_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red[kEmWarps];
  const int w = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, I = a.I, G = a.G, V = a.V;
  const int32_t* h1 = a.h1;
  const int32_t* h2 = a.h2;
  float* const table = kGlobal ? a.workspace + (size_t)w * table_floats(H, I) : smem;
  float* const LL = table;                     // [I, G] gl_rel
  float* const LW = LL + (size_t)I * G;        // [I, G] log responsibilities
  float* const RESP = LW + (size_t)I * G;      // [G] log_resp
  float* lf = RESP + G;                        // [H] log_freq
  float* nw = lf + H;                          // [H] the next log_freq
  float* const LV = nw + H;                    // [I] variant side, per individual
  const uint8_t* hm = a.hap_mask + (size_t)w * H;
  const uint8_t* hr = a.has_reads + (size_t)w * I;
  const size_t wig = (size_t)w * I * G;

  // The pair order the M-step relies on.
  int bad = 0;
  for (int i = tid; i < H; i += kEmThreads) {
    int g = pair_index(i, i, H);
    for (int j = i; j < H; ++j, ++g) bad |= (h1[g] != i) | (h2[g] != j);
  }
  if (__syncthreads_or(bad)) {
    poison_window(a, w);
    return;
  }

  // lik and gl_rel from gl, rows over warps.
  for (int i = warp; i < I; i += kEmWarps) {
    const float* gl = a.lik + wig + (size_t)i * G;
    float m = -INFINITY;
    for (int g = lane; g < G; g += 32) {
      if (hm[h1[g]] && hm[h2[g]]) m = fmaxf(m, gl[g]);
    }
    m = warp_max(m);
    const float ms = safe(m);
    const bool reads = hr[i];
    for (int g = lane; g < G; g += 32) {
      const size_t k = (size_t)i * G + g;
      const float v = gl[g];
      const bool on = hm[h1[g]] && hm[h2[g]];
      float lik = on ? fmaxf(expf(v - m), 0.0f) : 0.0f;
      float rel = on ? fmaxf(v - ms, kGlFloor) : -INFINITY;
      if (!reads) {
        lik = on ? 1.0f : 0.0f;
        rel = on ? 0.0f : -INFINITY;
      }
      LL[k] = rel;
      a.lik[wig + k] = lik;
      a.gl_rel[wig + k] = rel;
    }
  }

  int n_haps = 0, n_data = 0;
  for (int base = 0; base < H; base += kEmThreads)
    n_haps += __syncthreads_count(base + tid < H && hm[base + tid]);
  for (int base = 0; base < I; base += kEmThreads)
    n_data += __syncthreads_count(base + tid < I && hr[base + tid]);
  const float lf0 = -logf((float)max(n_haps, 1));
  const float log_denom = logf(2.0f * (float)max(n_data, 1));
  for (int h = tid; h < H; h += kEmThreads) lf[h] = hm[h] ? lf0 : -INFINITY;
  __syncthreads();

  float margin = INFINITY;
  int iters = 0;
  while (iters < a.em_iters) {
    // E-step: log_w = ll + (lf[h1] + lf[h2] + het), normalised per row.
    // Rows without reads stay out (their ll is -inf throughout).
    for (int i = warp; i < I; i += kEmWarps) {
      if (!hr[i]) continue;
      const float* ll = LL + (size_t)i * G;
      float* row = LW + (size_t)i * G;
      float m = -INFINITY;
      for (int g = lane; g < G; g += 32) {
        const int p = h1[g], q = h2[g];
        const float x = ll[g] + ((lf[p] + lf[q]) + (p != q ? kLog2 : 0.0f));
        row[g] = x;
        m = fmaxf(m, x);
      }
      m = warp_max(m);
      const float ms = safe(m);
      float s = 0.0f;
      for (int g = lane; g < G; g += 32) s += expf(row[g] - ms);
      const float log_s = lse_finish(m, warp_sum(s));
      const bool fin = isfinite(log_s);
      for (int g = lane; g < G; g += 32) row[g] = fin ? row[g] - log_s : -INFINITY;
    }
    __syncthreads();
    // log_resp[g]: logsumexp over the individuals with reads.
    for (int g = tid; g < G; g += kEmThreads) {
      float m = -INFINITY;
      for (int i = 0; i < I; ++i)
        if (hr[i]) m = fmaxf(m, LW[(size_t)i * G + g]);
      const float ms = safe(m);
      float s = 0.0f;
      for (int i = 0; i < I; ++i)
        if (hr[i]) s += expf(LW[(size_t)i * G + g] - ms);
      RESP[g] = lse_finish(m, s);
    }
    __syncthreads();
    // M-step, one warp per hap: the genotypes holding hap h are (k, h) for
    // k < h and (h, k) for k >= h; the homozygous one counts twice.
    for (int h = warp; h < H; h += kEmWarps) {
      float out = -INFINITY;
      if (hm[h]) {
        float m = -INFINITY;
        for (int k = lane; k < H; k += 32) {
          const int g = k < h ? pair_index(k, h, H) : pair_index(h, k, H);
          m = fmaxf(m, RESP[g] + (k == h ? kLog2 : 0.0f));
        }
        m = warp_max(m);
        const float ms = safe(m);
        float s = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const int g = k < h ? pair_index(k, h, H) : pair_index(h, k, H);
          s += expf((RESP[g] + (k == h ? kLog2 : 0.0f)) - ms);
        }
        out = lse_finish(m, warp_sum(s)) - log_denom;
      }
      if (lane == 0) nw[h] = out;
    }
    __syncthreads();
    // The reference's linear max-change test.
    float c = 0.0f;
    for (int h = tid; h < H; h += kEmThreads)
      c = fmaxf(c, fabsf(expf(nw[h]) - expf(lf[h])));
    c = warp_max(c);
    if (lane == 0) red[warp] = c;
    __syncthreads();
    float max_change = red[0];
#pragma unroll
    for (int k = 1; k < kEmWarps; ++k) max_change = fmaxf(max_change, red[k]);
    ++iters;
    margin = fminf(margin, fabsf(max_change - a.tol));
    float* t = lf;
    lf = nw;
    nw = t;
    if (max_change <= a.tol) break;
  }

  for (size_t k = tid; k < (size_t)I * G; k += kEmThreads) {
    const bool keep = iters > 0 && hr[k / G];
    a.em[wig + k] = keep ? expf(LW[k]) : 0.0f;
  }
  for (int h = tid; h < H; h += kEmThreads) a.freq[(size_t)w * H + h] = expf(lf[h]);
  if (tid == 0) {
    a.margin[w] = margin;
    a.iters[w] = iters;
  }
  if (V == 0) return;

  // Posterior log ratios.  The variant side, per individual with reads:
  // logsumexp_g(het + lf[h1] + lf[h2] + gl_rel), floored at -708.
  for (int i = warp; i < I; i += kEmWarps) {
    if (!hr[i]) continue;
    const float* ll = LL + (size_t)i * G;
    float m = -INFINITY;
    for (int g = lane; g < G; g += 32) {
      const int p = h1[g], q = h2[g];
      m = fmaxf(m, (((p != q ? kLog2 : 0.0f) + lf[p]) + lf[q]) + ll[g]);
    }
    m = warp_max(m);
    const float ms = safe(m);
    float s = 0.0f;
    for (int g = lane; g < G; g += 32) {
      const int p = h1[g], q = h2[g];
      s += expf(((((p != q ? kLog2 : 0.0f) + lf[p]) + lf[q]) + ll[g]) - ms);
    }
    s = warp_sum(s);
    const float out = isfinite(m) ? ms + logf(s) : kLogMin;
    if (lane == 0) LV[i] = fmaxf(out, kLogMin);
  }
  __syncthreads();
  // The no-variant side, one warp per variant: frequencies without the
  // variant's haps, renormalised, then the same sum; ratio = sum over the
  // individuals with reads of (no-variant - variant), in order.
  for (int v = warp; v < V; v += kEmWarps) {
    const uint8_t* vm = a.var_mask + ((size_t)w * V + v) * H;
    float m = -INFINITY;
    for (int h = lane; h < H; h += 32) m = fmaxf(m, vm[h] ? -INFINITY : lf[h]);
    m = warp_max(m);
    const float ms = safe(m);
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s += expf((vm[h] ? -INFINITY : lf[h]) - ms);
    const float log_s = lse_finish(m, warp_sum(s));
    const float shift = isfinite(log_s) ? log_s : 0.0f;
    const bool norm = isfinite(log_s);
    float acc = 0.0f;
    for (int i = 0; i < I; ++i) {
      if (!hr[i]) continue;
      const float* ll = LL + (size_t)i * G;
      float mi = -INFINITY;
      for (int g = lane; g < G; g += 32) {
        const int p = h1[g], q = h2[g];
        const float fp = vm[p] ? -INFINITY : (norm ? lf[p] - shift : lf[p]);
        const float fq = vm[q] ? -INFINITY : (norm ? lf[q] - shift : lf[q]);
        mi = fmaxf(mi, (((p != q ? kLog2 : 0.0f) + fp) + fq) + ll[g]);
      }
      mi = warp_max(mi);
      const float mis = safe(mi);
      float si = 0.0f;
      for (int g = lane; g < G; g += 32) {
        const int p = h1[g], q = h2[g];
        const float fp = vm[p] ? -INFINITY : (norm ? lf[p] - shift : lf[p]);
        const float fq = vm[q] ? -INFINITY : (norm ? lf[q] - shift : lf[q]);
        si += expf(((((p != q ? kLog2 : 0.0f) + fp) + fq) + ll[g]) - mis);
      }
      si = warp_sum(si);
      const float ln = fmaxf(isfinite(mi) ? mis + logf(si) : kLogMin, kLogMin);
      acc += ln - LV[i];
    }
    if (lane == 0) a.ratios[(size_t)w * V + v] = acc;
  }
}

}  // namespace

// Launches both kernels on `stream`; workspace null selects the shared
// memory path, else a [W, table_floats(H, I)] float workspace.  Returns
// the first CUDA error (0 when both launches were accepted).
extern "C" int ptt_infer_window_batch(
    const void* loglik, const void* onehot, const void* hap_mask,
    const void* h1, const void* h2, const void* var_mask, const void* has_reads,
    void* lik, void* em, void* freq, void* gof, void* ratios, void* gl_rel,
    void* margin, void* iters, void* workspace, int W, int H, int R, int I,
    int V, int em_iters, float tol, void* stream) {
  Args a;
  a.loglik = (const float*)loglik;
  a.onehot = (const float*)onehot;
  a.hap_mask = (const uint8_t*)hap_mask;
  a.h1 = (const int32_t*)h1;
  a.h2 = (const int32_t*)h2;
  a.var_mask = (const uint8_t*)var_mask;
  a.has_reads = (const uint8_t*)has_reads;
  a.lik = (float*)lik;
  a.em = (float*)em;
  a.freq = (float*)freq;
  a.gof = (float*)gof;
  a.ratios = (float*)ratios;
  a.gl_rel = (float*)gl_rel;
  a.margin = (float*)margin;
  a.iters = (int32_t*)iters;
  a.workspace = (float*)workspace;
  a.W = W;
  a.H = H;
  a.R = R;
  a.I = I;
  a.V = V;
  a.G = H * (H + 1) / 2;
  a.em_iters = em_iters;
  a.tol = tol;
  if (W <= 0 || H <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (a.G + kGlWarps - 1) / kGlWarps;
  infer_window_gl_kernel<<<(unsigned)((size_t)W * tiles), kGlWarps * 32, 0, s>>>(a, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (workspace) {
    infer_window_em_kernel<true><<<W, kEmThreads, 0, s>>>(a);
  } else {
    const size_t bytes = table_floats(H, I) * sizeof(float);
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(infer_window_em_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    infer_window_em_kernel<false><<<W, kEmThreads, bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}
