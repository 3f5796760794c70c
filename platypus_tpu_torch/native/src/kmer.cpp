// Native k-mer anchor voting: decide where each read aligns on a haplotype.
//
// Same contract as platypus_tpu_torch/ops/kmer.py::candidate_segments (which is
// the semantics oracle and numpy fallback), itself a rebuild of the
// reference's hash/vote machinery (Platypus src/cython/calign.pyx:
// 25-272): 7-mer rolling hash over the {&7, 7->2, &3} encoding, each read
// votes for every haplotype offset its k-mers occur at, every offset tied
// at the maximum vote count (subject to the band-fit constraint
// anchor + readLen + 15 < hapLen) becomes an anchor, plus the BAM mapping
// position; each anchor yields segment start max(0, anchor - 8).
//
// The numpy path pays ~0.4 ms of fixed vectorisation overhead per
// (window, hap) call on typical 30-read piles; this chain-table loop runs
// the same pile in ~10 us.  Output rows (read-major vote anchors ascending,
// then BAM anchors, first-occurrence dedup on (read, seg)) match the
// oracle byte-for-byte.
//
// C ABI only — loaded from Python via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kHashNucs = 7;
constexpr int kHashSize = 1 << (2 * kHashNucs);  // 4^7

inline int32_t base_code(uint8_t b) {
    int32_t c = b & 7;
    if (c == 7) c = 2;
    return c & 3;
}

}  // namespace

extern "C" {

// Returns the number of (read, seg) pairs, written to out_read/out_seg
// (capacity `cap` each).  If more than `cap` pairs exist, returns the
// required total WITHOUT writing past cap; the caller re-invokes with a
// larger buffer.  Reads shorter than 7 bases produce no pairs.
int32_t ptpu_kmer_segments(
    const uint8_t* hap_seq, int32_t hap_len,
    const uint8_t* read_seq, int32_t n_reads, int32_t row_len,
    const int32_t* read_len,
    const int64_t* read_start, int64_t hap_start,
    int32_t* out_read, int32_t* out_seg, int32_t cap) {
    // --- haplotype chain table over k-mer start positions 0..hap_len-8 ----
    static thread_local std::vector<int32_t> head;
    head.assign(kHashSize, -1);
    int32_t n_hap_kmers = hap_len - kHashNucs;  // count hap_len-7, see oracle
    if (n_hap_kmers < 0) n_hap_kmers = 0;
    std::vector<int32_t> next(n_hap_kmers, -1);
    {
        int32_t h = 0;
        for (int32_t i = 0; i < kHashNucs - 1 && i < hap_len; ++i)
            h = h * 4 + base_code(hap_seq[i]);
        for (int32_t p = 0; p < n_hap_kmers; ++p) {
            h = ((h * 4) + base_code(hap_seq[p + kHashNucs - 1])) & (kHashSize - 1);
            next[p] = head[h];
            head[h] = p;
        }
    }

    // votes indexed by anchor + row_len, anchor in [-row_len, hap_len].
    const int32_t vote_span = hap_len + row_len + 1;
    std::vector<uint16_t> votes(vote_span, 0);
    std::vector<int32_t> touched;
    touched.reserve(64);
    std::vector<int32_t> segs;  // per-read emitted segs (dedup scope)
    segs.reserve(8);

    // Phase 1: vote anchors, read-major, anchors ascending (the oracle's
    // sorted-unique-key order).  Phase 2 (BAM anchors) appends after ALL
    // vote pairs, so buffer phase-1 rows per read and BAM rows separately.
    std::vector<int32_t> vote_read, vote_seg;
    std::vector<int32_t> bam_read, bam_seg;
    // Per-read first-occurrence dedup needs phase-1 segs at phase-2 time.
    std::vector<std::vector<int32_t>> seen(n_reads);

    for (int32_t r = 0; r < n_reads; ++r) {
        const int32_t rl = read_len[r];
        if (rl < kHashNucs) continue;
        const uint8_t* row = read_seq + static_cast<int64_t>(r) * row_len;

        // k-mers 0..rl-8 (count rl-7), rolling hash.
        touched.clear();
        int32_t max_vote = 0;
        int32_t h = 0;
        for (int32_t i = 0; i < kHashNucs - 1; ++i) h = h * 4 + base_code(row[i]);
        const int32_t n_kmers = rl - kHashNucs;  // exclusive upper index
        for (int32_t k = 0; k < n_kmers; ++k) {
            h = ((h * 4) + base_code(row[k + kHashNucs - 1])) & (kHashSize - 1);
            for (int32_t p = head[h]; p != -1; p = next[p]) {
                const int32_t anchor = p - k;
                const int32_t v = ++votes[anchor + row_len];
                if (v == 1) touched.push_back(anchor);
                if (v > max_vote) max_vote = v;
            }
        }

        segs.clear();
        if (max_vote > 0) {
            // Ascending anchors among the touched set.
            // touched is small; insertion sort keeps it cheap.
            for (size_t i = 1; i < touched.size(); ++i) {
                int32_t key = touched[i];
                size_t j = i;
                while (j > 0 && touched[j - 1] > key) {
                    touched[j] = touched[j - 1];
                    --j;
                }
                touched[j] = key;
            }
            for (int32_t anchor : touched) {
                if (votes[anchor + row_len] == max_vote &&
                    anchor >= -rl && anchor + rl + 15 < hap_len) {
                    int32_t seg = anchor - 8;
                    if (seg < 0) seg = 0;
                    bool dup = false;
                    for (int32_t s : segs) {
                        if (s == seg) { dup = true; break; }
                    }
                    if (!dup) {
                        segs.push_back(seg);
                        vote_read.push_back(r);
                        vote_seg.push_back(seg);
                    }
                }
            }
        }
        for (int32_t anchor : touched) votes[anchor + row_len] = 0;
        seen[r] = segs;

        // BAM-position anchor (always tried for reads with >= 7 bases).
        int64_t bam_anchor = read_start[r] - hap_start;
        const int64_t fit = static_cast<int64_t>(hap_len) - rl - 15;
        if (bam_anchor > fit) bam_anchor = fit;
        int64_t seg64 = bam_anchor - 8;
        if (seg64 < 0) seg64 = 0;
        bam_read.push_back(r);
        bam_seg.push_back(static_cast<int32_t>(seg64));
    }

    // Emit: vote pairs first, then BAM pairs not already seen for the read.
    int32_t total = 0;
    for (size_t i = 0; i < vote_read.size(); ++i) {
        if (total < cap) {
            out_read[total] = vote_read[i];
            out_seg[total] = vote_seg[i];
        }
        ++total;
    }
    for (size_t i = 0; i < bam_read.size(); ++i) {
        const int32_t r = bam_read[i];
        bool dup = false;
        for (int32_t s : seen[r]) {
            if (s == bam_seg[i]) { dup = true; break; }
        }
        if (dup) continue;
        if (total < cap) {
            out_read[total] = r;
            out_seg[total] = bam_seg[i];
        }
        ++total;
    }
    return total;
}

// Whole-window variant: one call votes every haplotype against the same
// read pile (haplotype sequences concatenated, CSR offsets).  Emits the
// per-hap pair blocks back-to-back into out_read/out_seg with per-hap
// counts in out_counts; returns the total required (may exceed cap, in
// which case the caller regrows and retries).  Cuts the ctypes/numpy
// wrapper crossings from H per window to 1.
int32_t ptpu_kmer_segments_multi(
    const uint8_t* hap_flat, const int64_t* hap_off, const int64_t* hap_starts,
    int32_t n_haps,
    const uint8_t* read_seq, int32_t n_reads, int32_t row_len,
    const int32_t* read_len, const int64_t* read_start,
    int32_t* out_read, int32_t* out_seg, int32_t* out_counts, int32_t cap) {
    int32_t total = 0;
    for (int32_t h = 0; h < n_haps; ++h) {
        const int32_t written = total < cap ? total : cap;
        const int32_t rem = cap > total ? cap - total : 0;
        const int32_t n = ptpu_kmer_segments(
            hap_flat + hap_off[h], static_cast<int32_t>(hap_off[h + 1] - hap_off[h]),
            read_seq, n_reads, row_len, read_len, read_start, hap_starts[h],
            out_read + written, out_seg + written, rem);
        out_counts[h] = n;
        total += n;
    }
    return total;
}

// Same per-hap voting as ptpu_kmer_segments_multi, but the haplotypes
// live as rows of an [n_haps, stride] matrix with per-hap lengths — the
// engine already packs that matrix for the aligner, so the flat-blob
// copy + offset table of the _multi entry is skipped entirely.
int32_t ptpu_kmer_segments_strided(
    const uint8_t* hap_mat, int64_t stride, const int32_t* hap_len,
    const int64_t* hap_starts, int32_t n_haps,
    const uint8_t* read_seq, int32_t n_reads, int32_t row_len,
    const int32_t* read_len, const int64_t* read_start,
    int32_t* out_read, int32_t* out_seg, int32_t* out_counts, int32_t cap) {
    int32_t total = 0;
    for (int32_t h = 0; h < n_haps; ++h) {
        const int32_t written = total < cap ? total : cap;
        const int32_t rem = cap > total ? cap - total : 0;
        const int32_t n = ptpu_kmer_segments(
            hap_mat + (int64_t)h * stride, hap_len[h],
            read_seq, n_reads, row_len, read_len, read_start, hap_starts[h],
            out_read + written, out_seg + written, rem);
        out_counts[h] = n;
        total += n;
    }
    return total;
}

// Whole-region batch: every window's haplotype voting in ONE call on a
// small thread pool.  Per-window arrays are passed as pointer tables (the
// numpy buffers already exist in the per-window requests — no repacking).
// totals[w] returns the pair count; when it exceeds caps[w] the caller
// re-runs that window through the strided entry with a larger buffer.
void ptpu_kmer_segments_batch(
    const uint64_t* hap_mat_ptrs, const int64_t* hap_strides,
    const uint64_t* hap_len_ptrs, const uint64_t* hap_start_ptrs,
    const int32_t* H_arr,
    const uint64_t* seq_ptrs, const int32_t* R_arr, const int32_t* L_arr,
    const uint64_t* rlen_ptrs, const uint64_t* rstart_ptrs,
    const uint64_t* out_read_ptrs, const uint64_t* out_seg_ptrs,
    const uint64_t* out_count_ptrs, const int32_t* caps, int32_t* totals,
    int32_t n_windows, int32_t n_threads) {
    std::atomic<int> next(0);
    auto run = [&]() {
        for (;;) {
            int w = next.fetch_add(1);
            if (w >= n_windows) return;
            totals[w] = ptpu_kmer_segments_strided(
                reinterpret_cast<const uint8_t*>(hap_mat_ptrs[w]),
                hap_strides[w],
                reinterpret_cast<const int32_t*>(hap_len_ptrs[w]),
                reinterpret_cast<const int64_t*>(hap_start_ptrs[w]), H_arr[w],
                reinterpret_cast<const uint8_t*>(seq_ptrs[w]), R_arr[w],
                L_arr[w],
                reinterpret_cast<const int32_t*>(rlen_ptrs[w]),
                reinterpret_cast<const int64_t*>(rstart_ptrs[w]),
                reinterpret_cast<int32_t*>(out_read_ptrs[w]),
                reinterpret_cast<int32_t*>(out_seg_ptrs[w]),
                reinterpret_cast<int32_t*>(out_count_ptrs[w]), caps[w]);
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
