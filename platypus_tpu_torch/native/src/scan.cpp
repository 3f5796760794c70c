// Single-M mismatch candidate scan (host hot loop #5).
//
// C++ twin of CandidateGenerator._scan_single_m_batch
// (platypus_tpu_torch/candidates/cigar_gen.py), which mirrors the reference's
// M-segment SNP/MNP scan (Platypus src/cython/variant.pyx:518-610)
// for the dominant read shape: a single all-M CIGAR at read_off=ref_off=0.
//
// Most reads match the reference exactly inside their scannable span, so the
// kernel is a memcmp per read; only mismatching rows walk base-by-base,
// applying the reference's rules (no Ns on either side, base qual >=
// minBaseQual, candidate at least minFlank from both read ends) and merging
// qualifying mismatches closer than minFlank into MNP runs.  Candidates
// dedup in a hash map keyed by (pos, removed, added) with support counts,
// exactly like the Python batch's np.unique pass.

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "vcf_parts.h"

namespace {

struct ScanResult {
    // Insertion-ordered unique candidates.
    std::vector<int64_t> pos;
    std::vector<int32_t> count;
    std::vector<int32_t> n_removed;
    std::vector<int32_t> n_added;
    std::string blob;  // removed||added bytes back to back per candidate
    std::vector<int64_t> blob_off;
};

// Chunk-local scan state: candidates + the dedup map keyed by
// (pos, removed, added).  Chunks merge in row order, so the final
// candidate order is first-seen over the full row range — and the
// downstream consumer sorts variants anyway (engine/region.py), so only
// the (key -> count) multiset is contractual.
struct ScanChunk {
    ScanResult res;
    std::unordered_map<std::string, size_t> seen;
};

}  // namespace

extern "C" {

// Scan M segments of a row-major [R, L] seq/qual pile against the region
// reference cache.  Each of the n_rows items is one M segment:
// (row id, segment length, read offset, ref offset) — single-M reads pass
// offsets 0/0, multi-op reads pass their CIGAR-walk offsets
// (variant.pyx:518-610 with arbitrary read_off/ref_off).  pos/rlen are the
// full per-read arrays indexed by row id.  Returns an opaque handle (free
// with ptpu_scan_free) and writes the unique-candidate count / blob size
// through the out params.
void* ptpu_scan_m_segments(const uint8_t* seq, const uint8_t* qual,
                           int32_t L, const int64_t* rows, int64_t n_rows,
                           const int64_t* pos, const int32_t* rlen,
                           const int64_t* mlen, const int64_t* read_offs,
                           const int64_t* ref_offs, const char* ref,
                           int64_t ref_len, int64_t ref_start,
                           int32_t min_flank, int32_t min_base_qual,
                           int64_t* out_n, int64_t* out_blob,
                           int32_t n_threads) {
    // Chunked scan: each thread dedups its contiguous row range locally;
    // chunks then merge in row order (single-threaded, O(unique)).
    int nt = n_threads < 1 ? 1 : n_threads;
    if ((int64_t)nt * 2048 > n_rows) nt = (int)(n_rows / 2048) + 1;
    std::vector<ScanChunk> chunks(nt);

    auto scan_range = [&](ScanChunk& chunk, int64_t row_lo, int64_t row_hi) {
    auto* res = &chunk.res;
    auto& seen = chunk.seen;
    std::string key;
    std::vector<int32_t> mm_cols;

    for (int64_t i = row_lo; i < row_hi; ++i) {
        const int64_t r = rows[i];
        const int64_t read_off = read_offs[i];
        const uint8_t* srow = seq + r * L + read_off;
        const uint8_t* qrow = qual + r * L + read_off;
        const int64_t ref_base = pos[r] + ref_offs[i] - ref_start;

        int64_t lo = read_off == 0 ? min_flank : 0;
        if (-ref_base > lo) lo = -ref_base;
        int64_t hi = mlen[i];
        const int64_t read_cap = (int64_t)rlen[r] - min_flank - read_off;
        if (read_cap < hi) hi = read_cap;
        if (ref_len - ref_base < hi) hi = ref_len - ref_base;
        if (hi > L - read_off) hi = L - read_off;
        if (hi <= lo) continue;

        // Fast path: span matches the reference byte for byte.
        if (std::memcmp(srow + lo, ref + ref_base + lo, hi - lo) == 0)
            continue;

        mm_cols.clear();
        for (int64_t c = lo; c < hi; ++c) {
            const uint8_t rb = srow[c];
            const uint8_t fb = (uint8_t)ref[ref_base + c];
            if (rb != fb && rb != 'N' && fb != 'N' && qrow[c] >= min_base_qual)
                mm_cols.push_back((int32_t)c);
        }
        if (mm_cols.empty()) continue;

        // Merge mismatches with gaps <= min_flank into runs; emit each run.
        size_t g0 = 0;
        for (size_t j = 1; j <= mm_cols.size(); ++j) {
            if (j < mm_cols.size() &&
                mm_cols[j] - mm_cols[j - 1] <= min_flank)
                continue;
            const int32_t i0 = mm_cols[g0];
            const int32_t i1 = mm_cols[j - 1];
            const int64_t vpos = ref_base + i0 + ref_start;
            const int64_t cpos = vpos < 0 ? 0 : vpos;  // Variant clamps
            const int32_t n = i1 - i0 + 1;

            key.assign((const char*)&cpos, sizeof(cpos));
            key.append(ref + ref_base + i0, n);
            key.push_back('\xff');
            key.append((const char*)srow + i0, n);
            auto it = seen.find(key);
            if (it != seen.end()) {
                res->count[it->second] += 1;
            } else {
                seen.emplace(key, res->pos.size());
                res->pos.push_back(cpos);
                res->count.push_back(1);
                res->n_removed.push_back(n);
                res->n_added.push_back(n);
                res->blob_off.push_back((int64_t)res->blob.size());
                res->blob.append(ref + ref_base + i0, n);
                res->blob.append((const char*)srow + i0, n);
            }
            g0 = j;
        }
    }
    };  // scan_range

    if (nt <= 1) {
        scan_range(chunks[0], 0, n_rows);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nt);
        const int64_t per = (n_rows + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t lo = t * per;
            int64_t hi = lo + per < n_rows ? lo + per : n_rows;
            if (lo < hi)
                threads.emplace_back(scan_range, std::ref(chunks[t]), lo, hi);
        }
        for (auto& th : threads) th.join();
    }

    // Merge chunks in row order.
    auto* res = new ScanResult();
    if (nt == 1) {
        *res = std::move(chunks[0].res);
    } else {
        std::unordered_map<std::string, size_t> seen;
        std::string key;
        for (auto& chunk : chunks) {
            ScanResult& c = chunk.res;
            for (size_t k = 0; k < c.pos.size(); ++k) {
                const int64_t cpos = c.pos[k];
                const int32_t n = c.n_removed[k];
                const char* kb = c.blob.data() + c.blob_off[k];
                key.assign((const char*)&cpos, sizeof(cpos));
                key.append(kb, n);
                key.push_back('\xff');
                key.append(kb + n, n);
                auto it = seen.find(key);
                if (it != seen.end()) {
                    res->count[it->second] += c.count[k];
                } else {
                    seen.emplace(key, res->pos.size());
                    res->pos.push_back(cpos);
                    res->count.push_back(c.count[k]);
                    res->n_removed.push_back(n);
                    res->n_added.push_back(c.n_added[k]);
                    res->blob_off.push_back((int64_t)res->blob.size());
                    res->blob.append(kb, 2 * (size_t)n);
                }
            }
        }
    }
    res->blob_off.push_back((int64_t)res->blob.size());
    *out_n = (int64_t)res->pos.size();
    *out_blob = (int64_t)res->blob.size();
    return res;
}

void ptpu_scan_fill(void* handle, int64_t* pos, int32_t* count,
                    int32_t* n_removed, int32_t* n_added, int64_t* blob_off,
                    char* blob) {
    auto* res = (ScanResult*)handle;
    std::memcpy(pos, res->pos.data(), res->pos.size() * sizeof(int64_t));
    std::memcpy(count, res->count.data(), res->count.size() * sizeof(int32_t));
    std::memcpy(n_removed, res->n_removed.data(),
                res->n_removed.size() * sizeof(int32_t));
    std::memcpy(n_added, res->n_added.data(),
                res->n_added.size() * sizeof(int32_t));
    std::memcpy(blob_off, res->blob_off.data(),
                res->blob_off.size() * sizeof(int64_t));
    std::memcpy(blob, res->blob.data(), res->blob.size());
}

void ptpu_scan_free(void* handle) { delete (ScanResult*)handle; }

// ---------------------------------------------------------------------------
// Indel-read CIGAR walk (CandidateGenerator._scan_read,
// variant.pyx:612-717): for each given row, walk the CIGAR emitting
// flank-gated I/D candidates (deduped like the M scan) and the list of
// scannable M segments (fed to ptpu_scan_m_segments by the caller).
// Rows with a deletion outside the reference cache are reported back for
// the Python walk (it has file-backed reference access with the contig-end
// clamp); nothing is emitted for such rows, so there is no double count.
// ---------------------------------------------------------------------------

namespace {

struct IndelScan {
    ScanResult cands;
    std::vector<int64_t> mseg_row, mseg_len, mseg_roff, mseg_goff;
    std::vector<int64_t> py_rows;
};

}  // namespace

void* ptpu_scan_indel_walk(
    const uint8_t* seq, int32_t L,
    const uint32_t* cigar_flat, const int64_t* cigar_off,
    const int64_t* rows, int64_t n_rows,
    const int64_t* pos, const int32_t* rlen,
    const char* ref, int64_t ref_len, int64_t ref_start,
    int32_t min_flank, int32_t gen_snps, int32_t gen_indels,
    int64_t* out_n, int64_t* out_blob, int64_t* out_msegs, int64_t* out_py) {
    auto* res = new IndelScan();
    std::unordered_map<std::string, size_t> seen;
    std::string key;
    (void)rlen;

    auto emit = [&](int64_t vpos, const char* removed, int32_t n_rem,
                    const char* added, int32_t n_add) {
        const int64_t cpos = vpos < 0 ? 0 : vpos;  // Variant clamps
        key.assign((const char*)&cpos, sizeof(cpos));
        key.append(removed, n_rem);
        key.push_back('\xff');
        key.append(added, n_add);
        auto it = seen.find(key);
        if (it != seen.end()) {
            res->cands.count[it->second] += 1;
            return;
        }
        seen.emplace(key, res->cands.pos.size());
        res->cands.pos.push_back(cpos);
        res->cands.count.push_back(1);
        res->cands.n_removed.push_back(n_rem);
        res->cands.n_added.push_back(n_add);
        res->cands.blob_off.push_back((int64_t)res->cands.blob.size());
        res->cands.blob.append(removed, n_rem);
        res->cands.blob.append(added, n_add);
    };

    for (int64_t i = 0; i < n_rows; ++i) {
        const int64_t r = rows[i];
        const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];
        const int64_t n_ops = c1 - c0;
        const uint8_t* srow = seq + r * L;
        const int64_t read_start = pos[r];

        // Pre-pass: ANY deletion outside the reference cache (flank-gated
        // or not — deliberately conservative) sends the whole row to the
        // Python walk before anything is emitted.
        bool to_python = false;
        if (gen_indels) {
            int64_t goff = 0;
            for (int64_t ci = 0; ci < n_ops && !to_python; ++ci) {
                const uint32_t w = cigar_flat[c0 + ci];
                const uint32_t op = w & 0xF;
                const int64_t len = w >> 4;
                if (op == 2) {
                    const int64_t a = read_start + goff - ref_start;
                    if (a < 0 || a + len > ref_len) to_python = true;
                    goff += len;
                } else if (op == 0 || op == 7 || op == 8 || op == 3) {
                    goff += len;
                } else if (op == 4 && ci == 0) {
                    goff += len;
                }
            }
        }
        if (to_python) {
            res->py_rows.push_back(r);
            continue;
        }

        int64_t read_off = 0, ref_off = 0;
        for (int64_t ci = 0; ci < n_ops; ++ci) {
            const uint32_t w = cigar_flat[c0 + ci];
            const uint32_t op = w & 0xF;
            const int64_t len = w >> 4;
            if (op == 1 || op == 2) {  // I / D
                bool flank_ok = false;
                if (ci > 0) {
                    const uint32_t pw = cigar_flat[c0 + ci - 1];
                    if ((pw & 0xF) == 0 && (int64_t)(pw >> 4) >= min_flank)
                        flank_ok = true;
                }
                if (!flank_ok && ci < n_ops - 1) {
                    const uint32_t nw = cigar_flat[c0 + ci + 1];
                    if ((nw & 0xF) == 0 && (int64_t)(nw >> 4) >= min_flank)
                        flank_ok = true;
                }
                if (op == 1) {
                    if (flank_ok && gen_indels) {
                        bool has_n = false;
                        for (int64_t k = 0; k < len; ++k)
                            if (srow[read_off + k] == 'N') { has_n = true; break; }
                        if (!has_n)
                            emit(read_start + ref_off - 1, "", 0,
                                 (const char*)srow + read_off, (int32_t)len);
                    }
                    read_off += len;
                } else {
                    if (flank_ok && gen_indels) {
                        const int64_t a = read_start + ref_off - ref_start;
                        bool has_n = false;
                        for (int64_t k = 0; k < len; ++k)
                            if (ref[a + k] == 'N') { has_n = true; break; }
                        if (!has_n)
                            emit(read_start + ref_off - 1, ref + a,
                                 (int32_t)len, "", 0);
                    }
                    ref_off += len;
                }
            } else if (op == 0 || op == 7 || op == 8) {  // M / EQ / X
                if (!(op == 7 || (op == 0 && len < min_flank)) && gen_snps) {
                    res->mseg_row.push_back(r);
                    res->mseg_len.push_back(len);
                    res->mseg_roff.push_back(read_off);
                    res->mseg_goff.push_back(ref_off);
                }
                read_off += len;
                ref_off += len;
            } else if (op == 3) {  // N
                ref_off += len;
            } else if (op == 4) {  // S: leading soft clip moved pos left
                read_off += len;
                if (ci == 0) ref_off += len;
            }  // H / P: nothing
        }
    }
    res->cands.blob_off.push_back((int64_t)res->cands.blob.size());
    *out_n = (int64_t)res->cands.pos.size();
    *out_blob = (int64_t)res->cands.blob.size();
    *out_msegs = (int64_t)res->mseg_row.size();
    *out_py = (int64_t)res->py_rows.size();
    return res;
}

void ptpu_indel_fill(void* handle, int64_t* pos, int32_t* count,
                     int32_t* n_removed, int32_t* n_added, int64_t* blob_off,
                     char* blob, int64_t* mseg_row, int64_t* mseg_len,
                     int64_t* mseg_roff, int64_t* mseg_goff,
                     int64_t* py_rows) {
    auto* res = (IndelScan*)handle;
    const ScanResult& c = res->cands;
    // Guarded copies: memcpy from an empty vector's null data() is UB.
    auto copy = [](void* dst, const void* src, size_t n) {
        if (n) std::memcpy(dst, src, n);
    };
    copy(pos, c.pos.data(), c.pos.size() * sizeof(int64_t));
    copy(count, c.count.data(), c.count.size() * sizeof(int32_t));
    copy(n_removed, c.n_removed.data(), c.n_removed.size() * sizeof(int32_t));
    copy(n_added, c.n_added.data(), c.n_added.size() * sizeof(int32_t));
    copy(blob_off, c.blob_off.data(), c.blob_off.size() * sizeof(int64_t));
    copy(blob, c.blob.data(), c.blob.size());
    copy(mseg_row, res->mseg_row.data(), res->mseg_row.size() * 8);
    copy(mseg_len, res->mseg_len.data(), res->mseg_len.size() * 8);
    copy(mseg_roff, res->mseg_roff.data(), res->mseg_roff.size() * 8);
    copy(mseg_goff, res->mseg_goff.data(), res->mseg_goff.size() * 8);
    copy(py_rows, res->py_rows.data(), res->py_rows.size() * 8);
}

void ptpu_indel_free(void* handle) { delete (IndelScan*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched variant_supported_by_read (vcfutils.pyx:961-1072) for the INFO
// re-walks: the window's single-M rows vectorise in numpy; rows with any
// other CIGAR walk here instead of in Python (vcfout/records.py:51-99).
// CIGAR op codes are the BAM standard: M0 I1 D2 N3 S4 H5 P6 =7 X8.
// ---------------------------------------------------------------------------

extern "C" void ptpu_variant_supported(
    const uint32_t* cigar_flat, const int64_t* cigar_off,
    const uint8_t* seq, int32_t L, const int32_t* rlen, const int64_t* pos,
    const int64_t* rs_rows, const int64_t* win_rows, int64_t n,
    int64_t var_pos, const char* added, int32_t n_add, int32_t n_rem,
    int32_t exact, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t rr = rs_rows[i];
        const int64_t wr = win_rows[i];
        const uint8_t* srow = seq + wr * L;
        const int64_t read_start = pos[wr];
        const int32_t read_len = rlen[wr];
        int64_t ref_off = 0, read_off = 0;
        uint8_t supported = 0;
        const int64_t c0 = cigar_off[rr], c1 = cigar_off[rr + 1];
        for (int64_t ci = c0; ci < c1 && !supported; ++ci) {
            const uint32_t word = cigar_flat[ci];
            const int32_t op = (int32_t)(word & 0xF);
            const int64_t length = (int64_t)(word >> 4);
            switch (op) {
                case 1:  // I
                    if (n_add != n_rem) {
                        if (exact) {
                            if (n_add - n_rem == length &&
                                read_off + n_add <= L &&
                                std::memcmp(srow + read_off, added, n_add) == 0)
                                supported = 1;
                            ci = c1;  // Python returns either way
                        } else {
                            supported = 1;
                        }
                        break;
                    }
                    read_off += length;
                    break;
                case 2:  // D
                    if (n_add != n_rem) {
                        if (exact) {
                            supported = (n_rem - n_add == length);
                            ci = c1;  // Python returns either way
                        } else {
                            supported = 1;
                        }
                        break;
                    }
                    ref_off += length;
                    break;
                case 0: case 7: case 8: {  // M, =, X
                    const int64_t start = var_pos - read_start + read_off - ref_off;
                    if (ref_off + read_start <= var_pos &&
                        ref_off + read_start + length > var_pos &&
                        n_add == n_rem && start >= 0 &&
                        start + n_add <= read_len &&
                        std::memcmp(srow + start, added, n_add) == 0)
                        supported = 1;
                    read_off += length;
                    ref_off += length;
                    break;
                }
                case 3:  // N (mirrors the Python walk: both offsets advance)
                    read_off += length;
                    ref_off += length;
                    break;
                case 4:  // S
                    read_off += length;
                    if (ci == c0) ref_off += length;
                    break;
                default:  // H, P
                    break;
            }
        }
        out[i] = supported;
    }
}

// ---------------------------------------------------------------------------
// Per-(variant, individual) INFO accounting (vcfutils.pyx:1226-1459; the
// numpy batch in vcfout/records.py:compute_vcf_info): overlap + qual-good
// filtering of the individual's good/bad rows, read support (memcmp for
// single-M rows, CIGAR walk otherwise), strand counts, MMLQ window minima
// and read-position distances, in one call.
// ---------------------------------------------------------------------------

namespace {

// The CIGAR walk of ptpu_variant_supported, as a helper.
inline uint8_t walk_supported(const uint32_t* cigar_flat, int64_t c0,
                              int64_t c1, const uint8_t* srow, int32_t L,
                              int64_t read_start, int32_t read_len,
                              int64_t var_pos, const char* added,
                              int32_t n_add, int32_t n_rem, int32_t exact) {
    int64_t ref_off = 0, read_off = 0;
    uint8_t supported = 0;
    for (int64_t ci = c0; ci < c1 && !supported; ++ci) {
        const uint32_t word = cigar_flat[ci];
        const int32_t op = (int32_t)(word & 0xF);
        const int64_t length = (int64_t)(word >> 4);
        switch (op) {
            case 1:  // I
                if (n_add != n_rem) {
                    if (exact) {
                        if (n_add - n_rem == length && read_off + n_add <= L &&
                            std::memcmp(srow + read_off, added, n_add) == 0)
                            supported = 1;
                        ci = c1;
                    } else {
                        supported = 1;
                    }
                    break;
                }
                read_off += length;
                break;
            case 2:  // D
                if (n_add != n_rem) {
                    if (exact) {
                        supported = (n_rem - n_add == length);
                        ci = c1;
                    } else {
                        supported = 1;
                    }
                    break;
                }
                ref_off += length;
                break;
            case 0: case 7: case 8: {  // M, =, X
                const int64_t start = var_pos - read_start + read_off - ref_off;
                if (ref_off + read_start <= var_pos &&
                    ref_off + read_start + length > var_pos &&
                    n_add == n_rem && start >= 0 &&
                    start + n_add <= read_len &&
                    std::memcmp(srow + start, added, n_add) == 0)
                    supported = 1;
                read_off += length;
                ref_off += length;
                break;
            }
            case 3:  // N (mirrors the Python walk: both offsets advance)
                read_off += length;
                ref_off += length;
                break;
            case 4:  // S
                read_off += length;
                if (ci == c0) ref_off += length;
                break;
            default:
                break;
        }
    }
    return supported;
}

// Row passes overlap_qualgood: overlaps [var_min, var_max] and has no
// qual < 5 inside the clipped variant span.
inline bool overlap_qualgood_row(int64_t pos, int64_t end, int32_t rl,
                                 const uint8_t* qrow, int64_t var_min,
                                 int64_t var_max) {
    if (pos > var_max || end <= var_min) return false;
    int64_t lo = var_min - pos;
    if (lo < 0) lo = 0; else if (lo > rl) lo = rl;
    int64_t hi = var_max - pos;
    if (hi < 0) hi = 0; else if (hi > rl) hi = rl;
    for (int64_t c = lo; c < hi; ++c)
        if (qrow[c] < 5) return false;
    return true;
}

// One (variant, individual) pass: counters[13] = tc, tc_bad, tr, tc_ab,
// tr_ab, nf, nr, nf_sb, nr_sb, tcf, tcr, tcf_sb, tcr_sb; rmsmq; and
// min_quals (capacity n_good_rows), their count in *n_min_quals.
void info_accumulate_one(
    const ptpu::InfoReads& w, const int64_t* good_rows, int64_t n_good_rows,
    const int64_t* bad_rows, int64_t n_bad_rows, int64_t var_min,
    int64_t var_max, int64_t var_pos, const char* added, int32_t n_add,
    int32_t n_rem, int32_t exact, int32_t var_in_genotype,
    int32_t bad_reads_window, int64_t* counters, double* rmsmq,
    int32_t* min_quals, int64_t* n_min_quals) {
    const uint8_t* seq = w.seq;
    const uint8_t* qual = w.qual;
    const int32_t L = w.L;
    const int64_t* pos = w.pos;
    const int64_t* end = w.end;
    const int32_t* rlen = w.rlen;
    const int32_t* mapq = w.mapq;
    int64_t tc = 0, tc_bad = 0, tr = 0, tc_ab = 0, tr_ab = 0;
    int64_t nf = 0, nr = 0, nf_sb = 0, nr_sb = 0;
    int64_t tcf = 0, tcr = 0, tcf_sb = 0, tcr_sb = 0;
    double rms = 0.0;
    int64_t n_minq = 0;

    for (int64_t k = 0; k < n_bad_rows; ++k) {
        const int64_t r = bad_rows[k];
        if (!overlap_qualgood_row(pos[r], end[r], rlen[r], qual + r * L,
                                  var_min, var_max))
            continue;
        ++tc_bad;
        rms += (double)mapq[r] * (double)mapq[r];
    }

    for (int64_t k = 0; k < n_good_rows; ++k) {
        const int64_t r = good_rows[k];
        const uint8_t* qrow = qual + r * L;
        const int32_t rl = rlen[r];
        if (!overlap_qualgood_row(pos[r], end[r], rl, qrow, var_min, var_max))
            continue;
        ++tc;
        rms += (double)mapq[r] * (double)mapq[r];
        const bool rev = w.strand_reverse[r] != 0;
        if (rev) ++tcr; else ++tcf;
        if (var_in_genotype) {
            ++tc_ab;
            if (rev) ++tcr_sb; else ++tcf_sb;
        }

        // Support.
        uint8_t supp = 0;
        const uint8_t* srow = seq + r * L;
        if (w.single_m[r]) {
            if (n_add == n_rem) {
                const int64_t start = var_pos - pos[r];
                if (start >= 0 && start + n_add <= rl && start < rl &&
                    std::memcmp(srow + start, added, n_add) == 0)
                    supp = 1;
            }
        } else {
            const int32_t ci = w.nsm_idx[r];
            if (ci >= 0)
                supp = walk_supported(w.nsm_flat, w.nsm_off[ci],
                                      w.nsm_off[ci + 1], srow, L, pos[r], rl,
                                      var_pos, added, n_add, n_rem, exact);
        }

        if (supp) {
            ++tr;
            if (rev) ++nr; else ++nf;
            if (var_in_genotype) {
                ++tr_ab;
                if (rev) ++nr_sb; else ++nf_sb;
                // MMLQ: min qual inside the bad-reads window around the
                // variant, 0 for an empty window.
                const int64_t half = (bad_reads_window - 1) / 2;
                int64_t ws = var_min - pos[r] - half;
                if (ws < 0) ws = 0;
                int64_t we = var_max - pos[r] + half;
                if (we > rl) we = rl;
                int32_t mn = 255;
                for (int64_t c = ws; c < we; ++c)
                    if (qrow[c] < mn) mn = qrow[c];
                min_quals[n_minq++] = we > ws ? mn : 0;
            }
        }
    }

    counters[0] = tc; counters[1] = tc_bad; counters[2] = tr;
    counters[3] = tc_ab; counters[4] = tr_ab; counters[5] = nf;
    counters[6] = nr; counters[7] = nf_sb; counters[8] = nr_sb;
    counters[9] = tcf; counters[10] = tcr; counters[11] = tcf_sb;
    counters[12] = tcr_sb;
    *rmsmq = rms;
    *n_min_quals = n_minq;
}

}  // namespace

// Every (variant, individual) pass of a window in one call.  The rows are
// grouped by individual here, in one stable counting pass over sample_idx:
// individual i's good rows (is_good) and bad rows (neither good nor
// broken), each ascending.  Variant v is var_spec[v] = (var_min, var_max,
// var_pos, n_removed, n_added), its added bases the next n_added of
// added_flat; var_in_genotype is [V, I] row-major.  Outputs: counters
// [V, I, 14] (the 13 of info_accumulate_one, then the pass's number of
// min quals), rmsmq [V, I], the min quals of the passes in order
// (capacity V x n_rows), and n_good_bad[2] = the window's good and bad
// rows over every individual.
void ptpu::info_accumulate_window(
    const InfoReads& w, const int32_t* sample_idx, const uint8_t* is_good,
    const uint8_t* is_broken, int64_t n_rows, int32_t n_ind, int32_t n_var,
    const int64_t* var_spec, const char* added_flat,
    const uint8_t* var_in_genotype, int32_t exact, int32_t bad_reads_window,
    int64_t* counters, double* rmsmq, int32_t* min_quals,
    int64_t* n_good_bad) {
    // CSR offsets: good_off [n_ind + 1], then bad_off [n_ind + 1] into the
    // bad rows, which follow the good ones in `rows`.
    thread_local std::vector<int64_t> off, cursor, rows;
    off.assign(2 * ((size_t)n_ind + 1), 0);
    int64_t* good_off = off.data();
    int64_t* bad_off = good_off + n_ind + 1;
    for (int64_t r = 0; r < n_rows; ++r) {
        const int32_t s = sample_idx[r];
        if (s < 0 || s >= n_ind) continue;
        if (is_good[r]) ++good_off[s + 1];
        else if (!is_broken[r]) ++bad_off[s + 1];
    }
    for (int32_t i = 0; i < n_ind; ++i) {
        good_off[i + 1] += good_off[i];
        bad_off[i + 1] += bad_off[i];
    }
    const int64_t n_good = good_off[n_ind], n_bad = bad_off[n_ind];
    rows.resize((size_t)(n_good + n_bad) + 1);
    int64_t* good_rows = rows.data();
    int64_t* bad_rows = good_rows + n_good;
    cursor.assign(off.begin(), off.end());
    for (int64_t r = 0; r < n_rows; ++r) {
        const int32_t s = sample_idx[r];
        if (s < 0 || s >= n_ind) continue;
        if (is_good[r]) good_rows[cursor[s]++] = r;
        else if (!is_broken[r]) bad_rows[cursor[n_ind + 1 + s]++] = r;
    }
    n_good_bad[0] = n_good;
    n_good_bad[1] = n_bad;

    int64_t n_minq = 0;
    const char* added = added_flat;
    for (int32_t v = 0; v < n_var; ++v) {
        const int64_t* spec = var_spec + 5 * (int64_t)v;
        const int32_t n_add = (int32_t)spec[4];
        for (int32_t i = 0; i < n_ind; ++i) {
            const int64_t k = (int64_t)v * n_ind + i;
            int64_t* c = counters + k * 14;
            info_accumulate_one(
                w, good_rows + good_off[i], good_off[i + 1] - good_off[i],
                bad_rows + bad_off[i], bad_off[i + 1] - bad_off[i],
                spec[0], spec[1], spec[2], added, n_add, (int32_t)spec[3],
                exact, var_in_genotype[k], bad_reads_window, c, rmsmq + k,
                min_quals + n_minq, c + 13);
            n_minq += c[13];
        }
        added += n_add;
    }
}

extern "C" void ptpu_info_accumulate_window(
    const uint8_t* seq, const uint8_t* qual, int32_t L, const int64_t* pos,
    const int64_t* end, const int32_t* rlen, const int32_t* mapq,
    const uint8_t* strand_reverse, const uint8_t* single_m,
    const int32_t* nsm_idx, const uint32_t* nsm_flat, const int64_t* nsm_off,
    const int32_t* sample_idx, const uint8_t* is_good,
    const uint8_t* is_broken, int64_t n_rows, int32_t n_ind, int32_t n_var,
    const int64_t* var_spec, const char* added_flat,
    const uint8_t* var_in_genotype, int32_t exact, int32_t bad_reads_window,
    int64_t* counters, double* rmsmq, int32_t* min_quals,
    int64_t* n_good_bad) {
    const ptpu::InfoReads w{seq, qual, L, pos, end, rlen, mapq,
                            strand_reverse, single_m, nsm_idx, nsm_flat,
                            nsm_off};
    ptpu::info_accumulate_window(w, sample_idx, is_good, is_broken, n_rows,
                                 n_ind, n_var, var_spec, added_flat,
                                 var_in_genotype, exact, bad_reads_window,
                                 counters, rmsmq, min_quals, n_good_bad);
}
