// Banded pair-alignment DP for NVIDIA Hopper (sm_90a): K1.
//
// Replaces platypus_tpu/ops/align_pallas.py::_band_align_kernel (called
// through band_align_padded_pallas) and, in the pair entry, the gather/pad
// before it (platypus_tpu/ops/align_jax.py::_gather_pad_device).  Same
// contract as the plain torch versions in
// platypus_tpu_torch/ops/align_torch.py (band_align_padded_reference,
// band_align_pairs_reference) and the scalar spec
// platypus_tpu_torch/ops/align_core.py::band_align_single: quality-aware
// banded min-plus alignment in quarter-phred int32, an 8-cell antidiagonal
// wavefront, two phases per read base, M/I/D states, free haplotype end
// gaps, position-specific gap-open.  Returns (min exit cell + 0x8000) >> 2
// per pair, bit-identical to the plain versions for 4*quality values in
// [0, POS_INF] (every quality byte's).
//
// Two entries feed one DP body (dp_run):
// * ptt_band_align_pairs, the main path: the deduplicated uint8 matrices
//   hap / gap-open [H, L1B] and read / quality [A, L2] with int32 pair
//   rows (hap, read, segment start, read length) [B].  Each thread reads
//   its own pair's bytes from the matrices (pair_loader.cuh's PairLoader,
//   shared with K2) and applies gather/pad's
//   sentinels itself ('N' hap from column read_len + 15 on, columns
//   clamped to L1B - 1, gap-open past the read held at column
//   read_len + 14, read '0' and quality 64 from read_len on).
// * ptt_band_align, the padded entry: gather/pad's int32 column tensors
//   [L2+16, B] hap / 4*gap-open and [L2+8, B] read / 4*quality, read
//   directly (coalesced) from device memory.
//
// What bounds it: int32 issue.  The DP needs 157 integer instructions per
// (pair, step) over the 8 wavefront rows (chip_smoke.py DP_OPS_PER_STEP);
// a pair reads under 450 bytes.  Hopper issues the DPX min forms (VIMNMX,
// VIMNMX3, VIADDMNMX) at the int32 rate, one warp instruction per two
// clocks per SM sub-partition (PERF.md, K1's findings).  What the design
// does:
// * The wavefront's sliding windows (read and quality shifting up, hap
//   and gap-open shifting down) are circular 8-entry register buffers
//   indexed by the step modulo 8, a compile-time constant in the
//   unrolled body, so a shift is a register rename.  The main loop runs
//   blocks of kUnroll = 4 steps and rotates the buffers once per block
//   (12 moves each, on the FMA pipe): 8 steps a block would need no
//   rotation, but that body (~23 KB of SASS) measured slower, past what
//   the instruction cache holds.
// * Steps 0-7, which hold the init row (m = -0x8000 where row == step),
//   are peeled into one block of 8.
// * The blocks' shape is warp-uniform: plain blocks while no lane of the
//   warp can reach an exit cell, then blocks with the exit captures up to
//   the warp's longest read_len + 8, in which a lane past its own end
//   idles.  Per-lane choices made a warp of mixed read lengths run both
//   kinds of block one after the other.
// * The substitution cost is one LOP3, one unsigned min and one IMAD, and
//   the insert terms fold +nucprior into their adds (IADD3).
// * Each pair entry thread loads the next block's four steps as words
//   (read, quality; hap and gap-open by funnel shift of two aligned words)
//   while the current block computes, so their latency hides behind it.
//   Staging the pair's bytes in shared memory first measured slower, on
//   the main path's own chunks too (PERF.md): at one warp per SM
//   sub-partition or fewer the staging loads' latency is not hidden.
// * Block size: the largest of 128, 64 and 32 threads (one pair each)
//   that still gives at least one block per SM, so a 2048-pair chunk
//   spreads over 64 SMs instead of 16.
// The TPU kernel's 128-lane blocks and its (8, 128) tiles do not carry
// over; wgmma and TMA do not apply (no matrix product, no regular tile).
// int32 throughout: narrower forms would overflow POS_INF + gap sums.

#include "pair_loader.cuh"

namespace {

// One pair's wavefront.  At the start of a block at step t0, rb / qb hold
// the read base and 4*quality of step t0 - 1 - j in slot 7 - j (row r of
// step t0 + K reads slot (K - r) & 7), and hb / gb / nb the hap base,
// 4*gap-open and 'N' mask (0 for 'N', else all ones) of padded hap column
// t0 + j in slot j (row r reads slot (K + r) & 7 in the even phase of step
// t0 + K, (K + 1 + r) & 7 in the odd).
struct State {
  int m1[kLanes], i1[kLanes], d1[kLanes], m2[kLanes], i2[kLanes], d2[kLanes];
  int rb[kLanes], qb[kLanes], hb[kLanes], gb[kLanes], nb[kLanes];
  int minsc;
};

// Step t = t0 + K of the DP, K compile-time.  INIT: the block of steps
// 0-7 (t == K).  CAPTURE: the block may hold exit cells (exit_row =
// t - read_len in 0..7).
template <int K, bool INIT, bool CAPTURE>
__device__ __forceinline__ void dp_step(State& s, int rd, int q4, int hp,
                                        int g4, int exit_row, int ge,
                                        int npr) {
  // ---- even phase: step t's read enters in slot K --------------------
  s.rb[K] = rd;
  s.qb[K] = q4;
  if (INIT) {
    s.m1[K] = -0x8000;
    s.m2[K] = -0x8000;
  }
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    s.m1[r] = min(s.m1[r], min(s.i1[r], s.d1[r]));
    if (CAPTURE && r == exit_row) s.minsc = min(s.minsc, s.m1[r]);
  }
  int d1n[kLanes - 1];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const int c = (K + r) & 7;
    const int w = (K - r) & 7;
    s.m1[r] += sub(s.rb[w], s.hb[c], s.qb[w], s.nb[c]);
    if (r < kLanes - 1)
      d1n[r] = min(s.d2[r] + ge, min(s.m2[r], s.i2[r]) + s.gb[(K + r + 1) & 7]);
    s.i1[r] = min(s.i2[r] + (ge + npr), s.m2[r] + s.gb[c] + npr);
  }
  s.d1[0] = kPosInf;
#pragma unroll
  for (int r = 1; r < kLanes; ++r) s.d1[r] = d1n[r - 1];

  // ---- odd phase: hap column t + 8 enters in slot K ------------------
  s.hb[K] = hp;
  s.gb[K] = g4;
  s.nb[K] = hp == kNChar ? 0 : -1;
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    s.m2[r] = min(s.m2[r], min(s.i2[r], s.d2[r]));
    if (CAPTURE && r == exit_row) s.minsc = min(s.minsc, s.m2[r]);
  }
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const int c = (K + 1 + r) & 7;
    const int w = (K - r) & 7;
    s.m2[r] += sub(s.rb[w], s.hb[c], s.qb[w], s.nb[c]);
    s.d2[r] = min(s.d1[r] + ge, min(s.m1[r], s.i1[r]) + s.gb[c]);
  }
  // i2 reads rows r+1 of i1 / m1; row 7 is POS_INF.
#pragma unroll
  for (int r = 0; r < kLanes - 1; ++r)
    s.i2[r] = min(s.i1[r + 1] + (ge + npr),
                  s.m1[r + 1] + s.gb[(K + 1 + r) & 7] + npr);
  s.i2[kLanes - 1] = kPosInf;
}

// Steps t0 .. t0+N-1; a CAPTURE block stops at `stop` (the pair's last
// needed step + 1).
template <int N, bool INIT, bool CAPTURE, int K = 0>
__device__ __forceinline__ void dp_block(State& s, const Steps<N>& in, int t0,
                                         int stop, int read_len, int ge,
                                         int npr) {
  if constexpr (K < N) {
    if (CAPTURE && t0 + K >= stop) return;
    dp_step<K, INIT, CAPTURE>(s, in.rd[K], in.q4[K], in.hp[K], in.g4[K],
                              t0 + K - read_len, ge, npr);
    dp_block<N, INIT, CAPTURE, K + 1>(s, in, t0, stop, read_len, ge, npr);
  } else if constexpr (N % kLanes != 0) {
    rotate<N>(s.rb);
    rotate<N>(s.qb);
    rotate<N>(s.hb);
    rotate<N>(s.gb);
    rotate<N>(s.nb);
  }
}

// The DP body of both entries.  `ld` gives the padded hap / gap-open
// columns 0-7 (head) and each block's Steps (fetch).  `end` =
// min(read_len + 8, n_steps): the exit cells of row r lie at step
// read_len + r, so no later step can change the result.  `lo` (the warp's
// least end - 8: its shortest read, at most L2) and `hi` (its largest
// end) are warp-uniform, so every lane takes the same blocks.
template <class Loader>
__device__ __forceinline__ int dp_run(Loader& ld, int read_len, int end,
                                      int lo, int hi, int ge, int npr) {
  State s;
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    s.m1[r] = s.i1[r] = s.d1[r] = s.m2[r] = s.i2[r] = s.d2[r] = kPosInf;
    s.rb[r] = kPosInf;
    s.qb[r] = 64 * 4;
  }
  s.minsc = kPosInf;
  ld.head(s.hb, s.gb);
#pragma unroll
  for (int r = 0; r < kLanes; ++r) s.nb[r] = s.hb[r] == kNChar ? 0 : -1;
  {
    Steps<kLanes> in;
    if (lo >= kLanes) {
      ld.template fetch<false>(0, in);
      dp_block<kLanes, true, false>(s, in, 0, end, read_len, ge, npr);
    } else {
      ld.template fetch<true>(0, in);
      dp_block<kLanes, true, true>(s, in, 0, end, read_len, ge, npr);
    }
  }
  Steps<kUnroll> in;
  for (int t0 = kLanes; t0 < hi; t0 += kUnroll) {
    if (t0 + kUnroll <= lo) {
      ld.template fetch<false>(t0, in);
      dp_block<kUnroll, false, false>(s, in, t0, end, read_len, ge, npr);
    } else {
      ld.template fetch<true>(t0, in);
      dp_block<kUnroll, false, true>(s, in, t0, end, read_len, ge, npr);
    }
  }
  return (s.minsc + 0x8000) >> 2;  // arithmetic shift, as in the TPU kernel
}

// ---- the padded entry's loader: int32 columns [L, B] -----------------
struct PaddedLoader {
  const int32_t* __restrict__ hap;
  const int32_t* __restrict__ go4;
  const int32_t* __restrict__ read;
  const int32_t* __restrict__ qual4;
  size_t stride;  // B
  int b, last;    // last = n_steps - 1

  __device__ __forceinline__ void head(int* hb, int* gb) const {
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      hb[r] = __ldg(hap + r * stride + b);
      gb[r] = __ldg(go4 + r * stride + b);
    }
  }

  // CLAMP: a block past the lane's exit may run past n_steps; its extra
  // steps are never used, so they reload the last step.
  template <bool CLAMP, int N>
  __device__ __forceinline__ void fetch(int t0, Steps<N>& in) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int t = CLAMP ? min(t0 + k, last) : t0 + k;
      const size_t off = (size_t)t * stride + b;
      in.rd[k] = __ldg(read + off);
      in.q4[k] = __ldg(qual4 + off);
      in.hp[k] = __ldg(hap + off + kLanes * stride);
      in.g4[k] = __ldg(go4 + off + kLanes * stride);
    }
  }
};

__global__ void __launch_bounds__(kMaxThreads)
band_align_kernel(const int32_t* __restrict__ hap,   // [n_steps + 8, B]
                  const int32_t* __restrict__ go4,   // [n_steps + 8, B]
                  const int32_t* __restrict__ read,  // [n_steps, B]
                  const int32_t* __restrict__ qual4, // [n_steps, B]
                  const int32_t* __restrict__ rlen,  // [B]
                  int32_t* __restrict__ out,         // [B]
                  int B, int n_steps, int ge, int npr) {
  // A lane past B mirrors pair B-1 (so the warp's reductions and blocks
  // stay whole) and writes nothing.
  const int lane_b = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = min(lane_b, B - 1);
  PaddedLoader ld{hap, go4, read, qual4, (size_t)B, b, n_steps - 1};
  const int read_len = __ldg(rlen + b);
  const int end = min(read_len + kLanes, n_steps);
  const int lo = __reduce_min_sync(0xffffffffu, end - kLanes);
  const int hi = __reduce_max_sync(0xffffffffu, end);
  const int score = dp_run(ld, read_len, end, lo, hi, ge, npr);
  if (lane_b < B) out[b] = score;
}

__global__ void __launch_bounds__(kMaxThreads)
band_align_pairs_kernel(const uint8_t* __restrict__ hap_mat,   // [H, L1B]
                        const uint8_t* __restrict__ go_mat,    // [H, L1B]
                        const uint8_t* __restrict__ seq_mat,   // [A, L2]
                        const uint8_t* __restrict__ qual_mat,  // [A, L2]
                        const int32_t* __restrict__ pair_hap,  // [B]
                        const int32_t* __restrict__ pair_read, // [B]
                        const int32_t* __restrict__ pair_seg,  // [B]
                        const int32_t* __restrict__ rlen,      // [B]
                        int32_t* __restrict__ out,             // [B]
                        int B, int L1B, int L2, int ge, int npr,
                        int rq_aligned, int hg_aligned) {
  // As above, a lane past B mirrors pair B-1; no block-wide barrier.
  const int lane_b = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = min(lane_b, B - 1);
  const int read_len = __ldg(rlen + b);
  const int ph = __ldg(pair_hap + b), pr = __ldg(pair_read + b);
  const int end = min(read_len + kLanes, L2 + kLanes);
  PairLoader ld = pair_loader(hap_mat, go_mat, seq_mat, qual_mat, ph, pr,
                              __ldg(pair_seg + b), read_len, L1B, L2,
                              rq_aligned, hg_aligned);
  const int lo = __reduce_min_sync(0xffffffffu, end - kLanes);
  const int hi = __reduce_max_sync(0xffffffffu, end);
  const int score = dp_run(ld, read_len, end, lo, hi, ge, npr);
  if (lane_b < B) out[b] = score;
}

}  // namespace

// The padded entry.  Launch on `stream` without synchronising; returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int ptt_band_align(const void* hap, const void* go4,
                              const void* read, const void* qual4,
                              const void* rlen, void* out, int B, int n_steps,
                              int gapextend, int nucprior, void* stream) {
  const int P = threads_for(B);
  band_align_kernel<<<(B + P - 1) / P, P, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hap, (const int32_t*)go4, (const int32_t*)read,
      (const int32_t*)qual4, (const int32_t*)rlen, (int32_t*)out, B,
      n_steps, 4 * gapextend, 4 * nucprior);
  return (int)cudaGetLastError();
}

// The pair entry (the main path).  Same launch contract.
extern "C" int ptt_band_align_pairs(const void* hap_mat, const void* go_mat,
                                    const void* seq_mat, const void* qual_mat,
                                    const void* pair_hap, const void* pair_read,
                                    const void* pair_seg, const void* rlen,
                                    void* out, int B, int L1B, int L2,
                                    int gapextend, int nucprior, void* stream) {
  const int P = threads_for(B);
  const int rq_aligned = reads_aligned(seq_mat, qual_mat, L2);
  const int hg_aligned = haps_aligned(hap_mat, go_mat, L1B);
  band_align_pairs_kernel<<<(B + P - 1) / P, P, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hap_mat, (const uint8_t*)go_mat,
      (const uint8_t*)seq_mat, (const uint8_t*)qual_mat,
      (const int32_t*)pair_hap, (const int32_t*)pair_read,
      (const int32_t*)pair_seg, (const int32_t*)rlen, (int32_t*)out, B, L1B,
      L2, 4 * gapextend, 4 * nucprior, rq_aligned, hg_aligned);
  return (int)cudaGetLastError();
}
