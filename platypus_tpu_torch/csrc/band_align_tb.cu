// Traceback-mode banded pair-alignment DP for NVIDIA Hopper (sm_90a).
//
// Replaces platypus_tpu/ops/align_pallas.py::_band_align_tb_kernel (called
// through band_align_traceback_padded_pallas), the kernel behind
// --calculateFlankScore.  Same contract as the plain torch version
// platypus_tpu_torch/ops/align_torch.py::band_align_traceback_padded_reference
// and the scalar spec platypus_tpu/ops/align_core.py::band_align_traceback:
// the DP of band_align.cu, except that the low two bits of every cell carry
// the label of its predecessor state (M=00, I=01, D=11), so scores differ
// from band_align.cu's by up to 3 quarter-units.  Per pair it returns the
// traceback-mode score, the exit index 2*(read_len+row)+phase of the first
// strict minimum (rows ascending, even phase before odd), and for every
// step the 8 packed label words (even phase in bits 0-7, odd phase in bits
// 8-15) that the host backtrace (align_core.unpack_backpointers,
// traceback_from_backpointers) walks.
//
// What bounds it: the label stream.  Each (pair, step) stores 8 int32
// words (32 bytes) against about 60 integer operations per cell, so at
// B=16384 and 100 bp reads the kernel writes 57 MB where band_align.cu
// writes 64 KB.  Stores go column-major into [n_steps*8, B], one row per
// word, so a warp's 32 threads write 128 contiguous bytes per word.
//
// Design: one thread per pair, blocks of 128 threads, the ragged edge
// masked with b < B.  As in band_align.cu every 8-entry state is a fully
// unrolled register array; the exit candidates (val_e, val_o) are two more
// such arrays, set by unrolled compare-selects rather than a dynamic
// register index, and reduced once after the loop.  The order of operations
// is the TPU kernel's exactly: a label word is taken after `m1 += sub` and
// the d1/i1 updates, the stamps follow it, and in the odd phase row 7 of
// i2 is forced to POS_INF before its label and stamp, so it carries 0x7801
// into the next step.  Simple and right first; speed is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;          // align_core.N_LANES
constexpr int kPosInf = 0x7800;    // align_core.POS_INF
constexpr int kNChar = 'N';
constexpr int kThreads = 128;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__global__ void __launch_bounds__(kThreads)
band_align_tb_kernel(const int32_t* __restrict__ hap,   // [n_steps + 8, B]
                     const int32_t* __restrict__ go4,   // [n_steps + 8, B]
                     const int32_t* __restrict__ read,  // [n_steps, B]
                     const int32_t* __restrict__ qual4, // [n_steps, B]
                     const int32_t* __restrict__ rlen,  // [B]
                     int32_t* __restrict__ score,       // [B]
                     int32_t* __restrict__ idx,         // [B]
                     int32_t* __restrict__ bp,          // [n_steps * 8, B]
                     int B, int n_steps, int ge, int npr) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t stride = (size_t)B;

  int m1[kLanes], i1[kLanes], d1[kLanes], m2[kLanes], i2[kLanes], d2[kLanes];
  int s1w[kLanes], gow[kLanes], s2w[kLanes], q2w[kLanes];
  int val_e[kLanes], val_o[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    m1[r] = i1[r] = d1[r] = m2[r] = i2[r] = d2[r] = kPosInf;
    val_e[r] = val_o[r] = kPosInf;
    s1w[r] = hap[r * stride + b];
    gow[r] = go4[r * stride + b];
    s2w[r] = kPosInf;
    q2w[r] = 64 * 4;
  }
  const int read_len = rlen[b];

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
      if (r == exit_row) val_e[r] = m1[r];
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

    int word[kLanes];
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      word[r] = (m1[r] & 3) | ((i1[r] & 3) << 2) | ((d1[r] & 3) << 6);
      m1[r] &= ~3;
      i1[r] = (i1[r] & ~3) | 1;
      d1[r] = (d1[r] & ~3) | 3;
    }

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
      if (r == exit_row) val_o[r] = m2[r];
    }

#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      const int nq = s1w[r] == kNChar ? 0 : kPosInf;
      const int sub2 = imin(s2w[r] == s1w[r] ? 0 : q2w[r], nq);
      m2[r] += sub2;
      d2[r] = imin(d1[r] + ge, imin(m1[r], i1[r]) + gow[r]);
    }
    // i2 reads the shifted-down (already stamped) i1/m1 of rows r+1; row 7
    // is forced to POS_INF, then labelled and stamped like the others.
#pragma unroll
    for (int r = 0; r < kLanes - 1; ++r) {
      i2[r] = imin(i1[r + 1] + ge, m1[r + 1] + gow[r]) + npr;
    }
    i2[kLanes - 1] = kPosInf;

    int32_t* out = bp + (size_t)s2 * kLanes * stride + b;
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      const int odd = (m2[r] & 3) | ((i2[r] & 3) << 2) | ((d2[r] & 3) << 6);
      m2[r] &= ~3;
      i2[r] = (i2[r] & ~3) | 1;
      d2[r] = (d2[r] & ~3) | 3;
      out[r * stride] = word[r] | (odd << 8);
    }
  }

  // First strict minimum over (row ascending, even before odd).
  int best = imin(val_e[0], val_o[0]);
  int best_r = 0;
  int best_p = val_o[0] < val_e[0];
#pragma unroll
  for (int r = 1; r < kLanes; ++r) {
    const int row_min = imin(val_e[r], val_o[r]);
    if (row_min < best) {
      best = row_min;
      best_r = r;
      best_p = val_o[r] < val_e[r];
    }
  }
  score[b] = (best + 0x8000) >> 2;  // arithmetic shift, as in the TPU kernel
  idx[b] = 2 * (read_len + best_r) + best_p;
}

}  // namespace

// Launch on `stream` without synchronising.  Returns cudaGetLastError() so
// the caller can raise on a refused launch.
extern "C" int ptt_band_align_tb(const void* hap, const void* go4,
                                 const void* read, const void* qual4,
                                 const void* rlen, void* score, void* idx,
                                 void* bp, int B, int n_steps, int gapextend,
                                 int nucprior, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  band_align_tb_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hap, (const int32_t*)go4, (const int32_t*)read,
      (const int32_t*)qual4, (const int32_t*)rlen, (int32_t*)score,
      (int32_t*)idx, (int32_t*)bp, B, n_steps, 4 * gapextend, 4 * nucprior);
  return (int)cudaGetLastError();
}
