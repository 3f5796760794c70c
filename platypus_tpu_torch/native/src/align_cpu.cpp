// Banded quality-aware pair alignment — host CPU batch kernel.
//
// Direct translation of THIS project's scalar spec
// (platypus_tpu_torch/ops/align_core.py::band_align_single): an 8-lane
// antidiagonal wavefront in a min-plus semiring, quarter-phred int32
// scores with a -0x8000 fixed-point offset, free haplotype start/end
// gaps, position-specific gap opens, and final score
// (min + 0x8000) >> 2.  Bit-identical to the scalar oracle (and thus to
// the JAX/Pallas device kernels, which are pinned to the same spec).
//
// Used by the engine's CPU backend (nCPU worker processes): XLA:CPU runs
// the lax.scan formulation ~25x slower than this fixed-8-lane loop, which
// GCC auto-vectorizes over the lane dimension.
//
// C ABI, loaded via ctypes.

#include <immintrin.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int NL = 8;
constexpr int32_t INF = 0x7800;

int32_t band_align_one_scalar(const uint8_t* hap, const uint8_t* go,
                              const uint8_t* read, const uint8_t* qual, int len2,
                              int32_t ge4, int32_t npr4) {
    const int len1 = len2 + 2 * NL - 1;
    int32_t m1[NL], i1[NL], d1[NL], m2[NL], i2[NL], d2[NL];
    int32_t seq1win[NL], seq2win[NL], qual2win[NL], nqual[NL], gowin[NL];
    for (int l = 0; l < NL; l++) {
        m1[l] = i1[l] = d1[l] = m2[l] = i2[l] = d2[l] = INF;
        seq1win[l] = hap[l];
        seq2win[l] = INF;
        qual2win[l] = 64 * 4;
        nqual[l] = (seq1win[l] == 'N') ? 0 : INF;
        gowin[l] = 4 * (int32_t)go[l];
    }
    int32_t minscore = INF;
    for (int s2 = 0; s2 < len2 + NL; s2++) {
        // ---- even phase: antidiagonal 2*s2 ------------------------------
        int32_t newseq, newqual;
        if (s2 < len2) {
            newseq = read[s2];
            newqual = 4 * (int32_t)qual[s2];
        } else {
            newseq = '0';
            newqual = 64 * 4;
        }
        for (int l = NL - 1; l > 0; l--) {
            seq2win[l] = seq2win[l - 1];
            qual2win[l] = qual2win[l - 1];
        }
        seq2win[0] = newseq;
        qual2win[0] = newqual;

        if (s2 < NL) {
            m1[s2] = -0x8000;
            m2[s2] = -0x8000;
        }
        for (int l = 0; l < NL; l++) m1[l] = std::min(m1[l], std::min(i1[l], d1[l]));
        if (s2 >= len2) minscore = std::min(minscore, m1[s2 - len2]);
        for (int l = 0; l < NL; l++) {
            int32_t sub = std::min(seq2win[l] == seq1win[l] ? 0 : qual2win[l],
                                   nqual[l]);
            m1[l] += sub;
        }
        int32_t d1n[NL];
        for (int l = 0; l < NL; l++) {
            int32_t god = (l < NL - 1) ? gowin[l + 1] : 0;
            d1n[l] = std::min(d2[l] + ge4, std::min(m2[l], i2[l]) + god);
        }
        d1[0] = INF;
        for (int l = 1; l < NL; l++) d1[l] = d1n[l - 1];
        for (int l = 0; l < NL; l++) i1[l] = std::min(i2[l] + ge4, m2[l] + gowin[l]) + npr4;

        // ---- odd phase: antidiagonal 2*s2 + 1 ---------------------------
        const int32_t c = (NL + s2 < len1) ? hap[NL + s2] : 'N';
        for (int l = 0; l < NL - 1; l++) {
            seq1win[l] = seq1win[l + 1];
            nqual[l] = nqual[l + 1];
        }
        seq1win[NL - 1] = c;
        nqual[NL - 1] = (c == 'N') ? 0 : INF;
        const int goi = (NL + s2 < len1) ? NL + s2 : len1 - 1;
        for (int l = 0; l < NL - 1; l++) gowin[l] = gowin[l + 1];
        gowin[NL - 1] = 4 * (int32_t)go[goi];

        for (int l = 0; l < NL; l++) m2[l] = std::min(m2[l], std::min(i2[l], d2[l]));
        if (s2 >= len2) minscore = std::min(minscore, m2[s2 - len2]);
        for (int l = 0; l < NL; l++) {
            int32_t sub = std::min(seq2win[l] == seq1win[l] ? 0 : qual2win[l],
                                   nqual[l]);
            m2[l] += sub;
        }
        for (int l = 0; l < NL; l++)
            d2[l] = std::min(d1[l] + ge4, std::min(m1[l], i1[l]) + gowin[l]);
        int32_t i2n[NL];
        for (int l = 0; l < NL; l++) {
            int32_t i1d = (l < NL - 1) ? i1[l + 1] : INF;
            int32_t m1d = (l < NL - 1) ? m1[l + 1] : INF;
            i2n[l] = std::min(i1d + ge4, m1d + gowin[l]) + npr4;
        }
        for (int l = 0; l < NL; l++) i2[l] = i2n[l];
        i2[NL - 1] = INF;
    }
    return (minscore + 0x8000) >> 2;
}

// AVX2 formulation: the 8 lanes live in one __m256i; the lane shifts are
// cross-lane permutes + single-lane blends.  Same recurrence as the scalar
// version above (which is the dispatchable fallback and the test oracle).
__attribute__((target("avx2"))) int32_t band_align_one_avx2(
    const uint8_t* hap, const uint8_t* go, const uint8_t* read,
    const uint8_t* qual, int len2, int32_t ge4, int32_t npr4) {
    const int len1 = len2 + 2 * NL - 1;
    const __m256i vinf = _mm256_set1_epi32(INF);
    const __m256i vzero = _mm256_setzero_si256();
    const __m256i idx_up = _mm256_setr_epi32(0, 0, 1, 2, 3, 4, 5, 6);
    const __m256i idx_down = _mm256_setr_epi32(1, 2, 3, 4, 5, 6, 7, 7);
    const __m256i vstart = _mm256_set1_epi32(-0x8000);
    const __m256i vge = _mm256_set1_epi32(ge4);
    const __m256i vnpr = _mm256_set1_epi32(npr4);

    __m256i m1 = vinf, i1 = vinf, d1 = vinf, m2 = vinf, i2 = vinf, d2 = vinf;
    alignas(32) int32_t buf[NL];
    for (int l = 0; l < NL; l++) buf[l] = hap[l];
    __m256i seq1win = _mm256_load_si256((const __m256i*)buf);
    __m256i seq2win = vinf;
    __m256i qual2win = _mm256_set1_epi32(64 * 4);
    const __m256i vN = _mm256_set1_epi32('N');
    // nqual: 0 where hap char is N else INF
    __m256i nqual = _mm256_andnot_si256(_mm256_cmpeq_epi32(seq1win, vN), vinf);
    for (int l = 0; l < NL; l++) buf[l] = 4 * (int32_t)go[l];
    __m256i gowin = _mm256_load_si256((const __m256i*)buf);

    __m256i vmin = vinf;  // lane-j mins collected over the last NL steps
    alignas(32) int32_t mbuf[NL];

    for (int s2 = 0; s2 < len2 + NL; s2++) {
        // ---- even phase ------------------------------------------------
        int32_t newseq, newqual;
        if (s2 < len2) {
            newseq = read[s2];
            newqual = 4 * (int32_t)qual[s2];
        } else {
            newseq = '0';
            newqual = 64 * 4;
        }
        seq2win = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(seq2win, idx_up),
            _mm256_set1_epi32(newseq), 0x01);
        qual2win = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(qual2win, idx_up),
            _mm256_set1_epi32(newqual), 0x01);

        if (s2 < NL) {
            // one-hot blend of -0x8000 into lane s2
            alignas(32) int32_t mask[NL] = {0};
            mask[s2] = -1;
            __m256i vm = _mm256_load_si256((const __m256i*)mask);
            m1 = _mm256_blendv_epi8(m1, vstart, vm);
            m2 = _mm256_blendv_epi8(m2, vstart, vm);
        }
        m1 = _mm256_min_epi32(m1, _mm256_min_epi32(i1, d1));
        if (s2 >= len2) {
            _mm256_store_si256((__m256i*)mbuf, m1);
            vmin = _mm256_min_epi32(vmin, _mm256_set1_epi32(mbuf[s2 - len2]));
        }
        {
            __m256i eq = _mm256_cmpeq_epi32(seq2win, seq1win);
            __m256i sub = _mm256_min_epi32(_mm256_andnot_si256(eq, qual2win), nqual);
            m1 = _mm256_add_epi32(m1, sub);
        }
        {
            // god = shift_down(gowin, 0)
            __m256i god = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(gowin, idx_down), vzero, 0x80);
            __m256i d1n = _mm256_min_epi32(
                _mm256_add_epi32(d2, vge),
                _mm256_add_epi32(_mm256_min_epi32(m2, i2), god));
            d1 = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(d1n, idx_up), vinf, 0x01);
        }
        i1 = _mm256_add_epi32(
            _mm256_min_epi32(_mm256_add_epi32(i2, vge),
                             _mm256_add_epi32(m2, gowin)),
            vnpr);

        // ---- odd phase -------------------------------------------------
        const int32_t c = (NL + s2 < len1) ? hap[NL + s2] : 'N';
        seq1win = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(seq1win, idx_down),
            _mm256_set1_epi32(c), 0x80);
        nqual = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(nqual, idx_down),
            (c == 'N') ? vzero : vinf, 0x80);
        const int goi = (NL + s2 < len1) ? NL + s2 : len1 - 1;
        gowin = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(gowin, idx_down),
            _mm256_set1_epi32(4 * (int32_t)go[goi]), 0x80);

        m2 = _mm256_min_epi32(m2, _mm256_min_epi32(i2, d2));
        if (s2 >= len2) {
            _mm256_store_si256((__m256i*)mbuf, m2);
            vmin = _mm256_min_epi32(vmin, _mm256_set1_epi32(mbuf[s2 - len2]));
        }
        {
            __m256i eq = _mm256_cmpeq_epi32(seq2win, seq1win);
            __m256i sub = _mm256_min_epi32(_mm256_andnot_si256(eq, qual2win), nqual);
            m2 = _mm256_add_epi32(m2, sub);
        }
        d2 = _mm256_min_epi32(
            _mm256_add_epi32(d1, vge),
            _mm256_add_epi32(_mm256_min_epi32(m1, i1), gowin));
        {
            __m256i i1d = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(i1, idx_down), vinf, 0x80);
            __m256i m1d = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(m1, idx_down), vinf, 0x80);
            i2 = _mm256_add_epi32(
                _mm256_min_epi32(_mm256_add_epi32(i1d, vge),
                                 _mm256_add_epi32(m1d, gowin)),
                vnpr);
            i2 = _mm256_blend_epi32(i2, vinf, 0x80);
        }
    }
    _mm256_store_si256((__m256i*)mbuf, vmin);
    int32_t minscore = mbuf[0];
    return (minscore + 0x8000) >> 2;
}

int32_t band_align_one(const uint8_t* hap, const uint8_t* go,
                       const uint8_t* read, const uint8_t* qual, int len2,
                       int32_t ge4, int32_t npr4) {
    static const bool has_avx2 = __builtin_cpu_supports("avx2");
    if (has_avx2) return band_align_one_avx2(hap, go, read, qual, len2, ge4, npr4);
    return band_align_one_scalar(hap, go, read, qual, len2, ge4, npr4);
}

}  // namespace

extern "C" {

// Pairs reference rows of the dispatch group's deduplicated matrices:
// hap_mat/go_mat are [H, hap_stride] row-major (go in raw phred units),
// seq_mat/qual_mat are [A, seq_stride].  For pair k the haplotype segment
// is hap_mat[pair_hap[k], pair_seg[k] : pair_seg[k] + rlen[k] + 15] and
// the read is seq_mat[pair_read[k], :rlen[k]].
void ptpu_band_align_pairs(const uint8_t* hap_mat, const uint8_t* go_mat,
                           int64_t hap_stride, const uint8_t* seq_mat,
                           const uint8_t* qual_mat, int64_t seq_stride,
                           const int64_t* pair_hap, const int64_t* pair_read,
                           const int64_t* pair_seg, const int32_t* rlen,
                           int64_t n_pairs, int32_t gapextend,
                           int32_t nucprior, int32_t n_threads,
                           int64_t* out) {
    const int32_t ge4 = 4 * gapextend;
    const int32_t npr4 = 4 * nucprior;
    auto run = [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            const uint8_t* hap = hap_mat + pair_hap[k] * hap_stride + pair_seg[k];
            const uint8_t* go = go_mat + pair_hap[k] * hap_stride + pair_seg[k];
            const uint8_t* rd = seq_mat + pair_read[k] * seq_stride;
            const uint8_t* ql = qual_mat + pair_read[k] * seq_stride;
            out[k] = band_align_one(hap, go, rd, ql, rlen[k], ge4, npr4);
        }
    };
    int nt = (int)std::max<int64_t>(
        1, std::min<int64_t>(n_threads, (n_pairs + 511) / 512));
    if (nt <= 1) {
        run(0, n_pairs);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(nt);
    int64_t per = (n_pairs + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n_pairs, lo + per);
        if (lo < hi) threads.emplace_back(run, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
