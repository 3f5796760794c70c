// Traceback-mode banded pair-alignment DP for NVIDIA Hopper (sm_90a): K2.
//
// Replaces platypus_tpu/ops/align_pallas.py::_band_align_tb_kernel (called
// through band_align_traceback_padded_pallas), the kernel behind
// --calculateFlankScore, and the gather/pad before it
// (platypus_tpu/ops/align_jax.py::_gather_pad_device).  Same contract as
// the plain torch version
// platypus_tpu_torch/ops/align_torch.py::band_align_traceback_pairs_reference
// and the scalar spec platypus_tpu_torch/ops/align_core.py::band_align_traceback:
// the DP of band_align.cu, except that the low two bits of every cell carry
// the label of its predecessor state (M=00, I=01, D=11), so scores differ
// from band_align.cu's by up to 3 quarter-units.  Per pair it returns the
// traceback-mode score, the exit index 2*(read_len+row)+phase of the first
// strict minimum (rows ascending, even phase before odd), and for every
// step the 8 packed 16-bit label words (even phase in bits 0-7, odd phase
// in bits 8-15) that the host backtrace (align_core.unpack_backpointers,
// traceback_from_backpointers) walks.
//
// One entry, ptt_band_align_tb_pairs: the deduplicated uint8 matrices hap /
// gap-open [H, L1B] and read / quality [A, L2] with int32 pair rows (hap,
// read, segment start, read length) [B], as K1's pair entry takes them;
// each thread gathers and pads its own pair (pair_loader.cuh).
//
// What bounds it: int32 issue.  Each (pair, step) needs 281 integer
// instructions over the 8 rows (chip_smoke.py TB_OPS_PER_STEP), 124 of
// them for the label words and stamps, and every step of every pair is
// written: 8 label words of 2 bytes, 28 MB at B=16384 and L2=100, which at
// the card's memory rate take about a third of the operations' time.
// What the design does (each choice measured on the card, PERF.md):
// * K1's loop: the sliding windows are circular 8-slot registers indexed
//   by the step modulo 8 (a shift is a rename), steps 0-7 (the init row)
//   are peeled into one block of 8, the rest runs in blocks of kUnroll = 4
//   steps with one rotation each (and one shorter last block where L2 is
//   not a multiple of 4), and each block's words are loaded while the
//   block before it computes.
// * No early stop: the whole label block is the contract, so unlike K1 a
//   thread runs every step 0 .. n_steps-1 of its pair.
// * The exit captures are tracked online in best / best_idx, in every
//   block: the exit cell of row r lies at step read_len + r, so rows
//   ascending are steps ascending, and a strict `<` update, even phase
//   before odd, keeps the first strict minimum the TPU kernel resolves
//   after its loop.  best starts above every cell, so row 0 always sets
//   it.  Each phase picks its exit row's cell by a select tree on the
//   row's bits (7 selects).  Blocks without captures beside them
//   (warp-uniform, from the warp's least and largest read_len) took 255
//   registers and more code and measured 18-60% slower.
// * A row's label word is built from the six cells' low bits by five bit
//   selects (one LOP3 each) of the cells shifted to their fields, whose
//   zero low bits fill the gaps; bits above 15 are never stored.  The d1
//   row 0 and i2 row 7 cells are the constant POS_INF, so their fields
//   and stamps fold away.  The order of operations is the TPU kernel's: a
//   label is taken after `m1 += sub` and the d1 / i1 updates, the stamps
//   follow it, and i2 row 7 is forced to POS_INF before its label and
//   stamp, so it carries 0x7801 into the next step.
// * 16-bit label stores, column-major [n_steps*8, B]: a warp's 32 threads
//   write 64 contiguous bytes per row word.  A thread past B exits first.
// * Block size from threads_for: 128, 64 or 32 threads, at least one
//   block per SM.
// int32 arithmetic throughout, with an arithmetic >> 2 for the score.

#include "pair_loader.cuh"

namespace {

constexpr int kNoExit = 0x7fffffff;  // above every cell: no exit candidate

// One pair's wavefront, with State's window slots as in band_align.cu,
// and the best exit cell so far and its index.
struct TbState {
  int m1[kLanes], i1[kLanes], d1[kLanes], m2[kLanes], i2[kLanes], d2[kLanes];
  int rb[kLanes], qb[kLanes], hb[kLanes], gb[kLanes], nb[kLanes];
  int best, best_idx;
};

// What every step of a pair needs besides its inputs.
struct TbPair {
  int read_len, n_steps, ge, npr;
  uint16_t* out;  // the pair's column of the label block
  size_t stride;  // B
};

// `a`'s bits under `mask`, `b`'s above it: one LOP3.
__device__ __forceinline__ unsigned below(unsigned a, unsigned b,
                                          unsigned mask) {
  return (a & mask) | (b & ~mask);
}

// Each state's low two bits become its own label: M ..00, I ..01, D ..11.
// An I cell's low bits are 00 or 01 (it is the min of a stamped I or M
// cell plus multiples of 4), so `i | 1` is (i & ~3) | 1 in one LOP3.
__device__ __forceinline__ void stamp(int& m, int& i, int& d) {
  m &= ~3;
  i |= 1;
  d |= 3;
}

// v[row], or kNoExit for a row outside 0..7: a select tree on row's bits.
__device__ __forceinline__ int pick(const int* v, int row) {
  const bool b0 = row & 1, b1 = row & 2, b2 = row & 4;
  const int a0 = b0 ? v[1] : v[0], a1 = b0 ? v[3] : v[2];
  const int a2 = b0 ? v[5] : v[4], a3 = b0 ? v[7] : v[6];
  const int c0 = b1 ? a1 : a0, c1 = b1 ? a3 : a2;
  const int c = b2 ? c1 : c0;
  return (unsigned)row < kLanes ? c : kNoExit;
}

// Step t = t0 + K, K compile-time.  INIT: the block of steps 0-7 (t == K).
// Row t - read_len, if in 0..7, holds the pair's exit cell at this step.
template <int K, bool INIT>
__device__ __forceinline__ void tb_step(TbState& s, int rd, int q4, int hp,
                                        int g4, int t0, const TbPair& p) {
  const int ge = p.ge, npr = p.npr;
  // The row holding this step's exit cell, if it is in 0..7.
  const int exit_row = t0 + K - p.read_len;
  // ---- even phase: step t's read enters in slot K --------------------
  s.rb[K] = rd;
  s.qb[K] = q4;
  if (INIT) {
    s.m1[K] = -0x8000;
    s.m2[K] = -0x8000;
  }
#pragma unroll
  for (int r = 0; r < kLanes; ++r)
    s.m1[r] = min(s.m1[r], min(s.i1[r], s.d1[r]));
  const int ve = pick(s.m1, exit_row);
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
  // The even byte: M in bits 0-1, I in 2-3, D in 6-7 (4-5 stay 0).
  unsigned word[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    word[r] = below(below(s.m1[r], (unsigned)s.i1[r] << 2, 0x3),
                    (unsigned)s.d1[r] << 6, 0xf);
    stamp(s.m1[r], s.i1[r], s.d1[r]);
  }

  // ---- odd phase: hap column t + 8 enters in slot K ------------------
  s.hb[K] = hp;
  s.gb[K] = g4;
  s.nb[K] = hp == kNChar ? 0 : -1;
#pragma unroll
  for (int r = 0; r < kLanes; ++r)
    s.m2[r] = min(s.m2[r], min(s.i2[r], s.d2[r]));
  const int vo = pick(s.m2, exit_row);
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const int c = (K + 1 + r) & 7;
    const int w = (K - r) & 7;
    s.m2[r] += sub(s.rb[w], s.hb[c], s.qb[w], s.nb[c]);
    s.d2[r] = min(s.d1[r] + ge, min(s.m1[r], s.i1[r]) + s.gb[c]);
  }
  // i2 reads rows r+1 of the stamped i1 / m1; row 7 is POS_INF.
#pragma unroll
  for (int r = 0; r < kLanes - 1; ++r)
    s.i2[r] = min(s.i1[r + 1] + (ge + npr),
                  s.m1[r + 1] + s.gb[(K + 1 + r) & 7] + npr);
  s.i2[kLanes - 1] = kPosInf;
  // The odd byte: M in bits 8-9, I in 10-11, D in 14-15 (12-13 stay 0).
  uint16_t* out = p.out + (size_t)(t0 + K) * kLanes * p.stride;
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    word[r] = below(word[r], (unsigned)s.m2[r] << 8, 0xff);
    word[r] = below(word[r], (unsigned)s.i2[r] << 10, 0x3ff);
    word[r] = below(word[r], (unsigned)s.d2[r] << 14, 0xfff);
    stamp(s.m2[r], s.i2[r], s.d2[r]);
    out[r * p.stride] = (uint16_t)word[r];
  }
  const int t2 = 2 * (t0 + K);
  if (ve < s.best) {
    s.best = ve;
    s.best_idx = t2;
  }
  if (vo < s.best) {
    s.best = vo;
    s.best_idx = t2 + 1;
  }
}

// Steps t0 .. t0+N-1; a TAIL block (the last, which may run past the
// label block) stops at n_steps.
template <int N, bool INIT, bool TAIL = false, int K = 0>
__device__ __forceinline__ void tb_block(TbState& s, const Steps<N>& in,
                                         int t0, const TbPair& p) {
  if constexpr (K < N) {
    if (TAIL && t0 + K >= p.n_steps) return;
    tb_step<K, INIT>(s, in.rd[K], in.q4[K], in.hp[K], in.g4[K], t0, p);
    tb_block<N, INIT, TAIL, K + 1>(s, in, t0, p);
  } else if constexpr (N % kLanes != 0) {
    rotate<N>(s.rb);
    rotate<N>(s.qb);
    rotate<N>(s.hb);
    rotate<N>(s.gb);
    rotate<N>(s.nb);
  }
}

// Every step of one pair: the first block of 8, blocks of kUnroll, and a
// last block of fewer steps where L2 is not a multiple of kUnroll.
__device__ __forceinline__ void tb_run(PairLoader& ld, const TbPair& p,
                                       int& score, int& idx) {
  TbState s;
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    s.m1[r] = s.i1[r] = s.d1[r] = s.m2[r] = s.i2[r] = s.d2[r] = kPosInf;
    s.rb[r] = kPosInf;
    s.qb[r] = 64 * 4;
  }
  s.best = kNoExit;
  s.best_idx = 0;
  ld.head(s.hb, s.gb);
#pragma unroll
  for (int r = 0; r < kLanes; ++r) s.nb[r] = s.hb[r] == kNChar ? 0 : -1;
  {
    Steps<kLanes> in;
    ld.template fetch<false>(0, in);
    tb_block<kLanes, true>(s, in, 0, p);
  }
  Steps<kUnroll> in;
  int t0 = kLanes;
  for (; t0 + kUnroll <= p.n_steps; t0 += kUnroll) {
    ld.template fetch<false>(t0, in);
    tb_block<kUnroll, false>(s, in, t0, p);
  }
  if (t0 < p.n_steps) {
    ld.template fetch<false>(t0, in);
    tb_block<kUnroll, false, true>(s, in, t0, p);
  }
  score = (s.best + 0x8000) >> 2;  // arithmetic shift, as in the TPU kernel
  idx = s.best_idx;
}

__global__ void __launch_bounds__(kMaxThreads)
band_align_tb_pairs_kernel(const uint8_t* __restrict__ hap_mat,   // [H, L1B]
                           const uint8_t* __restrict__ go_mat,    // [H, L1B]
                           const uint8_t* __restrict__ seq_mat,   // [A, L2]
                           const uint8_t* __restrict__ qual_mat,  // [A, L2]
                           const int32_t* __restrict__ pair_hap,  // [B]
                           const int32_t* __restrict__ pair_read, // [B]
                           const int32_t* __restrict__ pair_seg,  // [B]
                           const int32_t* __restrict__ rlen,      // [B]
                           int32_t* __restrict__ score_out,       // [B]
                           int32_t* __restrict__ idx_out,         // [B]
                           uint16_t* __restrict__ bp,     // [(L2+8)*8, B]
                           int B, int L1B, int L2, int ge, int npr,
                           int rq_aligned, int hg_aligned) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int read_len = __ldg(rlen + b);
  PairLoader ld = pair_loader(hap_mat, go_mat, seq_mat, qual_mat,
                              __ldg(pair_hap + b), __ldg(pair_read + b),
                              __ldg(pair_seg + b), read_len, L1B, L2,
                              rq_aligned, hg_aligned);
  const TbPair p{read_len, L2 + kLanes, ge, npr, bp + b, (size_t)B};
  int score, idx;
  tb_run(ld, p, score, idx);
  score_out[b] = score;
  idx_out[b] = idx;
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError() so
// the caller can raise on a refused launch.  The pair rows are not
// bound-checked here: callers check them first.
extern "C" int ptt_band_align_tb_pairs(const void* hap_mat, const void* go_mat,
                                       const void* seq_mat,
                                       const void* qual_mat,
                                       const void* pair_hap,
                                       const void* pair_read,
                                       const void* pair_seg, const void* rlen,
                                       void* score, void* idx, void* bp, int B,
                                       int L1B, int L2, int gapextend,
                                       int nucprior, void* stream) {
  const int P = threads_for(B);
  band_align_tb_pairs_kernel<<<(B + P - 1) / P, P, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hap_mat, (const uint8_t*)go_mat,
      (const uint8_t*)seq_mat, (const uint8_t*)qual_mat,
      (const int32_t*)pair_hap, (const int32_t*)pair_read,
      (const int32_t*)pair_seg, (const int32_t*)rlen, (int32_t*)score,
      (int32_t*)idx, (uint16_t*)bp, B, L1B, L2, 4 * gapextend,
      4 * nucprior, reads_aligned(seq_mat, qual_mat, L2),
      haps_aligned(hap_mat, go_mat, L1B));
  return (int)cudaGetLastError();
}
