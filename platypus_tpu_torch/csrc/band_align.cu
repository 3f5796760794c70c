// Banded pair-alignment DP for NVIDIA Hopper (sm_90a).
//
// Replaces platypus_tpu/ops/align_pallas.py::_band_align_kernel (called
// through band_align_padded_pallas).  Same contract as the plain torch
// version platypus_tpu_torch/ops/align_torch.py::band_align_padded_reference
// and the scalar spec platypus_tpu_torch/ops/align_core.py::band_align_single:
// quality-aware banded min-plus alignment in quarter-phred int32, an 8-cell
// antidiagonal wavefront, two phases per read base, M/I/D states, free
// haplotype end gaps, position-specific gap-open.  Returns
// (min exit cell + 0x8000) >> 2 per pair, bit-identical to the reference.
//
// What bounds it: int32 ALU issue.  The DP needs 157 integer instructions
// per (pair, step) over the 8 wavefront rows (chip_smoke.py
// DP_OPS_PER_STEP) and reads four int32 words, so device-memory bytes are
// negligible.  The result needs only the steps up to read_len + 7; this
// loop runs all n_steps, and the init-row and exit-row compares on every
// step.
//
// Design: one thread per pair, blocks of 128 threads, the ragged edge
// masked with b < B (no lane padding).  All wavefront state lives in
// fully unrolled 8-entry register arrays: the TPU kernel's sublane rolls
// (_shift_up/_shift_down) become register renames, and the init row and
// exit-row extraction are unrolled compare-selects instead of a dynamic
// register index, which would spill to local memory.  Inputs stay
// column-major [L, B], so each step's four loads are coalesced across a
// warp.  wgmma and TMA do not apply: there is no matrix product and no
// tile to stage.  Simple and right first; speed is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;          // align_core.N_LANES
constexpr int kPosInf = 0x7800;    // align_core.POS_INF
constexpr int kNChar = 'N';
constexpr int kThreads = 128;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__global__ void __launch_bounds__(kThreads)
band_align_kernel(const int32_t* __restrict__ hap,   // [n_steps + 8, B]
                  const int32_t* __restrict__ go4,   // [n_steps + 8, B]
                  const int32_t* __restrict__ read,  // [n_steps, B]
                  const int32_t* __restrict__ qual4, // [n_steps, B]
                  const int32_t* __restrict__ rlen,  // [B]
                  int32_t* __restrict__ out,         // [B]
                  int B, int n_steps, int ge, int npr) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t stride = (size_t)B;

  int m1[kLanes], i1[kLanes], d1[kLanes], m2[kLanes], i2[kLanes], d2[kLanes];
  int s1w[kLanes], gow[kLanes], s2w[kLanes], q2w[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    m1[r] = i1[r] = d1[r] = m2[r] = i2[r] = d2[r] = kPosInf;
    s1w[r] = hap[r * stride + b];
    gow[r] = go4[r * stride + b];
    s2w[r] = kPosInf;
    q2w[r] = 64 * 4;
  }
  const int read_len = rlen[b];
  int minsc = kPosInf;

  for (int s2 = 0; s2 < n_steps; ++s2) {
    const size_t off = (size_t)s2 * stride + b;
    const int new_seq2 = read[off];
    const int new_qual2 = qual4[off];
    const int hap_c = hap[off + kLanes * stride];
    const int go_c = go4[off + kLanes * stride];
    // Exactly one row holds the exit cell while the wavefront crosses the
    // read's end (0 <= exit_row < 8); otherwise no row matches.
    const int exit_row = s2 - read_len;

    // ---- even phase ------------------------------------------------------
#pragma unroll
    for (int r = kLanes - 1; r > 0; --r) {
      s2w[r] = s2w[r - 1];
      q2w[r] = q2w[r - 1];
    }
    s2w[0] = new_seq2;
    q2w[0] = new_qual2;

#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      if (r == s2) {  // only fires while s2 < 8
        m1[r] = -0x8000;
        m2[r] = -0x8000;
      }
      m1[r] = imin(m1[r], imin(i1[r], d1[r]));
      if (r == exit_row) minsc = imin(minsc, m1[r]);
    }

    int d1_new[kLanes];
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      const int nq = s1w[r] == kNChar ? 0 : kPosInf;
      const int sub = imin(s2w[r] == s1w[r] ? 0 : q2w[r], nq);
      m1[r] += sub;
      const int gow_down = r < kLanes - 1 ? gow[r + 1] : 0;
      d1_new[r] = imin(d2[r] + ge, imin(m2[r], i2[r]) + gow_down);
      i1[r] = imin(i2[r] + ge, m2[r] + gow[r]) + npr;
    }
    d1[0] = kPosInf;
#pragma unroll
    for (int r = 1; r < kLanes; ++r) d1[r] = d1_new[r - 1];

    // ---- odd phase -------------------------------------------------------
#pragma unroll
    for (int r = 0; r < kLanes - 1; ++r) {
      s1w[r] = s1w[r + 1];
      gow[r] = gow[r + 1];
    }
    s1w[kLanes - 1] = hap_c;
    gow[kLanes - 1] = go_c;

#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      m2[r] = imin(m2[r], imin(i2[r], d2[r]));
      if (r == exit_row) minsc = imin(minsc, m2[r]);
    }

#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      const int nq = s1w[r] == kNChar ? 0 : kPosInf;
      const int sub2 = imin(s2w[r] == s1w[r] ? 0 : q2w[r], nq);
      m2[r] += sub2;
      d2[r] = imin(d1[r] + ge, imin(m1[r], i1[r]) + gow[r]);
    }
    // i2 reads the shifted-down i1/m1 of rows r+1; row 7 is forced to
    // POS_INF, so rows are updated in ascending order from unchanged i1/m1.
#pragma unroll
    for (int r = 0; r < kLanes - 1; ++r) {
      i2[r] = imin(i1[r + 1] + ge, m1[r + 1] + gow[r]) + npr;
    }
    i2[kLanes - 1] = kPosInf;
  }
  out[b] = (minsc + 0x8000) >> 2;  // arithmetic shift, as in the TPU kernel
}

}  // namespace

// Launch on `stream` without synchronising.  Returns cudaGetLastError() so
// the caller can raise on a refused launch.
extern "C" int ptt_band_align(const void* hap, const void* go4,
                              const void* read, const void* qual4,
                              const void* rlen, void* out, int B, int n_steps,
                              int gapextend, int nucprior, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  band_align_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hap, (const int32_t*)go4, (const int32_t*)read,
      (const int32_t*)qual4, (const int32_t*)rlen, (int32_t*)out, B,
      n_steps, 4 * gapextend, 4 * nucprior);
  return (int)cudaGetLastError();
}
