// What the banded-alignment kernels share: K1 (band_align.cu) and K2, its
// traceback mode (band_align_tb.cu).  Both pair entries read the
// deduplicated uint8 matrices hap / gap-open [H, L1B] and read / quality
// [A, L2] through int32 pair rows (hap, read, segment start, read length)
// [B], and each thread gathers and pads its own pair here (PairLoader),
// with gather/pad's sentinels ('N' hap from column read_len + 15 on,
// columns clamped to L1B - 1, gap-open past the read held at column
// read_len + 14, read '0' and quality 64 from read_len on).  Each .cu
// builds into its own library; this header's definitions live in an
// unnamed namespace, a private copy in each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;          // align_core.N_LANES
constexpr int kPosInf = 0x7800;    // align_core.POS_INF
constexpr int kNChar = 'N';
constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kUnroll = 4;  // steps per block of the main loop: one word

// The inputs of N consecutive steps: read, 4*quality, and the hap and
// 4*gap-open column each step brings in (column step + 8).
template <int N>
struct Steps {
  int rd[N], q4[N], hp[N], g4[N];
};

// The substitution cost min(read == hap ? 0 : q4, hap 'N' ? 0 : POS_INF),
// which is q4 * (read != hap && hap != 'N') for q4 in [0, POS_INF].
__device__ __forceinline__ int sub(int rd, int hp, int q4, int nmask) {
  return q4 * (int)min((unsigned)((rd ^ hp) & nmask), 1u);
}

// Rotate an 8-slot buffer by N, so that a block of N < 8 steps leaves it
// as the next block's K = 0 expects (a block of 8 leaves it in place).
template <int N>
__device__ __forceinline__ void rotate(int* b) {
  int t[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) t[j] = b[(j + N) & 7];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) b[j] = t[j];
}

// ---- the pair entries: one pair's rows in the matrices ----------------
__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Each block's words come from device memory directly, the next block's
// loaded while the current one computes.
struct PairLoader {
  const uint8_t* __restrict__ hrow;  // the pair's hap row, gap-open row,
  const uint8_t* __restrict__ grow;  // read row and quality row
  const uint8_t* __restrict__ srow;
  const uint8_t* __restrict__ qrow;
  int ps, L1B;      // segment start, hap matrix width
  int valid;        // read bytes before the '0' / 64 sentinels
  int len1;         // hap columns before the 'N' sentinel
  bool rq_aligned;  // read / quality rows start on 4-byte boundaries
  bool hg_aligned;  // hap / gap-open rows start on 4-byte boundaries
  uint32_t nr, nq, nh, ng;  // the next block's words

  // Four read (or quality) bytes from step s0, `pad` past `valid`.
  __device__ __forceinline__ uint32_t read_word(const uint8_t* row_ptr, int s0,
                                                uint32_t pad) const {
    if (rq_aligned && s0 + 4 <= valid) return ldg32(row_ptr + s0);
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t byte = s0 + k < valid ? __ldg(row_ptr + s0 + k)
                                           : (pad >> (8 * k)) & 0xff;
      w |= byte << (8 * k);
    }
    return w;
  }

  // Padded hap / gap-open columns c0 .. c0+3, as gather/pad makes them:
  // straight from the rows (a funnel shift of two aligned words) where no
  // sentinel or clamp applies, else byte by byte.
  __device__ __forceinline__ void hap_words(int c0, uint32_t& hw,
                                            uint32_t& gw) const {
    const int a = ps + c0;
    if (hg_aligned && a >= 0 && c0 + 4 <= len1 && a + 4 <= L1B) {
      const int lo = a & ~3, hi = min(lo + 4, L1B - 4), sh = 8 * (a & 3);
      hw = __funnelshift_r(ldg32(hrow + lo), ldg32(hrow + hi), sh);
      gw = __funnelshift_r(ldg32(grow + lo), ldg32(grow + hi), sh);
      return;
    }
    const int lastc = max(len1 - 1, 0);
    hw = gw = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      const int col = min(ps + min(c, lastc), L1B - 1);
      const uint32_t h = c < len1 ? __ldg(hrow + col) : kNChar;
      hw |= h << (8 * k);
      gw |= uint32_t(__ldg(grow + col)) << (8 * k);
    }
  }

  // The words of steps s0 .. s0+3: read, quality, and hap / gap-open
  // columns s0+8 .. s0+11.
  __device__ __forceinline__ void load(int s0, uint32_t& r, uint32_t& q,
                                       uint32_t& h, uint32_t& g) const {
    r = read_word(srow, s0, 0x30303030u);  // '0'
    q = read_word(qrow, s0, 0x40404040u);  // 64
    hap_words(s0 + kLanes, h, g);
  }

  __device__ __forceinline__ void head(int* hb, int* gb) const {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint32_t h, g;
      hap_words(4 * w, h, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hb[4 * w + k] = (h >> (8 * k)) & 0xff;
        gb[4 * w + k] = ((g >> (8 * k)) & 0xff) << 2;
      }
    }
  }

  // The peeled first block (N = 8) loads its own words; a block of the
  // main loop takes the words loaded by the block before it.  Either
  // then loads the next block's.
  template <bool CLAMP, int N>
  __device__ __forceinline__ void fetch(int t0, Steps<N>& in) {
#pragma unroll
    for (int w = 0; w < N / 4; ++w) {
      uint32_t r, q, h, g;
      if (N != kUnroll) {
        load(t0 + 4 * w, r, q, h, g);
      } else {
        r = nr, q = nq, h = nh, g = ng;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        in.rd[4 * w + k] = (r >> (8 * k)) & 0xff;
        in.q4[4 * w + k] = ((q >> (8 * k)) & 0xff) << 2;
        in.hp[4 * w + k] = (h >> (8 * k)) & 0xff;
        in.g4[4 * w + k] = ((g >> (8 * k)) & 0xff) << 2;
      }
    }
    load(t0 + N, nr, nq, nh, ng);
  }
};

// The loader of pair (hap row ph, read row pr, segment start ps, read
// length read_len) in the matrices; the *_aligned flags as
// reads_aligned / haps_aligned give them.
__device__ __forceinline__ PairLoader pair_loader(
    const uint8_t* hap_mat, const uint8_t* go_mat, const uint8_t* seq_mat,
    const uint8_t* qual_mat, int ph, int pr, int ps, int read_len, int L1B,
    int L2, int rq_aligned, int hg_aligned) {
  PairLoader ld;
  ld.hrow = hap_mat + (size_t)ph * L1B;
  ld.grow = go_mat + (size_t)ph * L1B;
  ld.srow = seq_mat + (size_t)pr * L2;
  ld.qrow = qual_mat + (size_t)pr * L2;
  ld.ps = ps;
  ld.L1B = L1B;
  ld.valid = max(min(read_len, L2), 0);
  ld.len1 = read_len + 15;
  ld.rq_aligned = rq_aligned != 0;
  ld.hg_aligned = hg_aligned != 0;
  return ld;
}

// Threads per block: the largest of 128, 64, 32 that still gives every SM
// a block (one pair per thread).
int threads_for(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int P = kMaxThreads;
  while (P > kMinThreads && (B + P - 1) / P < sms) P /= 2;
  return P;
}

// Whether the read / quality rows (first) and the hap / gap-open rows
// (second) start on 4-byte boundaries, so PairLoader may load words.
int reads_aligned(const void* seq_mat, const void* qual_mat, int L2) {
  return L2 % 4 == 0 && (uintptr_t)seq_mat % 4 == 0 &&
         (uintptr_t)qual_mat % 4 == 0;
}

int haps_aligned(const void* hap_mat, const void* go_mat, int L1B) {
  return L1B % 4 == 0 && L1B >= 4 && (uintptr_t)hap_mat % 4 == 0 &&
         (uintptr_t)go_mat % 4 == 0;
}

}  // namespace
