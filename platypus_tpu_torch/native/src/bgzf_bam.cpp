// Native host I/O plane: BGZF decompression, BAI region queries and BAM
// record decoding into structure-of-arrays batches, plus the in-place read
// QC trimming loops.
//
// This is the TPU-era replacement for the role htslib plays in the
// reference caller (Platypus src/cython/htslibWrapper.pyx): the
// Python layer (platypus_tpu_torch/io/bam.py) remains as a pure fallback and as
// the semantics oracle; this library accelerates the same contract.
//
// C ABI only — loaded from Python via ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

struct BgzfFile {
    FILE* fh = nullptr;
    // Current read position: the mapped block and the offset within it.
    int64_t block_coffset = -1;
    int64_t block_clen = 0;
    const std::vector<uint8_t>* blockp = nullptr;  // into `cache`
    size_t within = 0;

    ~BgzfFile() {
        if (fh) fclose(fh);
    }

    bool open(const char* path) {
        fh = fopen(path, "rb");
        return fh != nullptr;
    }

    // Persistent inflated-block cache: BGZF blocks are independent deflate
    // streams laid out back-to-back, so a region fetch bulk-reads a
    // multi-block span and inflates the blocks on several threads (the
    // reference pays this cost serially inside htslib).  The cache lives
    // for the life of the reader, so adjacent region fetches (the driver
    // walks buffer-sized shards sequentially) never re-inflate a block;
    // FIFO-evicted above a byte cap so whole-genome scans stay bounded.
    struct CachedBlock {
        int64_t clen;
        std::vector<uint8_t> data;
    };
    std::unordered_map<int64_t, CachedBlock> cache;   // by coffset
    std::deque<int64_t> cache_order;                  // insertion order
    size_t cache_bytes = 0;

    static size_t cache_cap() {
        static size_t cap = [] {
            const char* env = std::getenv("PLATYPUS_TPU_BGZF_CACHE_MB");
            long mb = (env && *env) ? std::atol(env) : 64;
            if (mb < 8) mb = 8;
            return (size_t)mb << 20;
        }();
        return cap;
    }

    static constexpr int64_t kBulkBytes = 4 << 20;  // compressed span per batch
    // Default inflate parallelism; PLATYPUS_TPU_INFLATE_THREADS overrides
    // (the runner sets it per worker so nCPU workers don't oversubscribe
    // the host with nCPU*6 inflate threads).
    static int inflate_threads() {
        static int n = [] {
            const char* env = std::getenv("PLATYPUS_TPU_INFLATE_THREADS");
            if (env && *env) {
                int v = std::atoi(env);
                if (v >= 1) return v;
            }
            return 6;
        }();
        return n;
    }

    struct ParsedBlock {
        int64_t coffset;
        int64_t bsize;
        size_t cdata_off;   // into the bulk buffer
        int64_t cdata_len;
        uint32_t isize;
    };

    // Parse one block header at `p` (with `avail` bytes); returns false if
    // the block is malformed or extends past the buffer.
    static bool parse_block(const uint8_t* p, size_t avail, int64_t coffset,
                            ParsedBlock* out) {
        if (avail < 18 || p[0] != 0x1f || p[1] != 0x8b) return false;
        uint16_t xlen;
        memcpy(&xlen, p + 10, 2);
        if (avail < (size_t)12 + xlen) return false;
        int bsize = -1;
        const uint8_t* extra = p + 12;
        for (size_t i = 0; i + 4 <= xlen;) {
            uint8_t si1 = extra[i], si2 = extra[i + 1];
            uint16_t slen;
            memcpy(&slen, extra + i + 2, 2);
            if (si1 == 66 && si2 == 67 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, extra + i + 4, 2);
                bsize = bs + 1;
                break;
            }
            i += 4 + slen;
        }
        if (bsize < 0 || avail < (size_t)bsize) return false;
        out->coffset = coffset;
        out->bsize = bsize;
        out->cdata_off = 12 + xlen;
        out->cdata_len = bsize - 12 - xlen - 8;
        memcpy(&out->isize, p + bsize - 4, 4);
        return out->cdata_len >= 0;
    }

    static bool inflate_one(const uint8_t* cdata, int64_t cdata_len,
                            std::vector<uint8_t>& dst, uint32_t isize) {
        dst.resize(isize);
        if (isize == 0) return true;
        z_stream zs{};
        inflateInit2(&zs, -15);
        zs.next_in = const_cast<uint8_t*>(cdata);
        zs.avail_in = (uInt)cdata_len;
        zs.next_out = dst.data();
        zs.avail_out = isize;
        int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        return rc == Z_STREAM_END;
    }

    // Bulk-read from `coffset` and inflate every whole block in the span.
    bool load_batch(int64_t coffset, int64_t span) {
        if (fseeko(fh, coffset, SEEK_SET) != 0) return false;
        std::vector<uint8_t> bulk(span);
        size_t got = fread(bulk.data(), 1, bulk.size(), fh);
        if (got == 0) return false;
        std::vector<ParsedBlock> parsed;
        size_t off = 0;
        while (off < got) {
            ParsedBlock pb;
            if (!parse_block(bulk.data() + off, got - off, coffset + off, &pb)) break;
            pb.cdata_off += off;
            parsed.push_back(pb);
            off += pb.bsize;
        }
        if (parsed.empty()) return false;
        // Inflate only blocks not already cached.
        std::vector<size_t> todo;
        todo.reserve(parsed.size());
        for (size_t i = 0; i < parsed.size(); ++i)
            if (!cache.count(parsed[i].coffset)) todo.push_back(i);
        std::vector<std::vector<uint8_t>> inflated(todo.size());
        std::atomic<size_t> next_idx{0};
        std::atomic<bool> ok{true};
        auto worker = [&]() {
            for (;;) {
                size_t j = next_idx.fetch_add(1);
                if (j >= todo.size()) return;
                const ParsedBlock& pb = parsed[todo[j]];
                if (!inflate_one(bulk.data() + pb.cdata_off, pb.cdata_len,
                                 inflated[j], pb.isize))
                    ok = false;
            }
        };
        int n_threads = std::min<int>(inflate_threads(), (int)todo.size());
        if (n_threads <= 1) {
            worker();
        } else {
            std::vector<std::thread> threads;
            for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
            for (auto& t : threads) t.join();
        }
        if (!ok) return false;
        for (size_t j = 0; j < todo.size(); ++j) {
            const ParsedBlock& pb = parsed[todo[j]];
            cache_bytes += inflated[j].size();
            cache.emplace(pb.coffset,
                          CachedBlock{pb.bsize, std::move(inflated[j])});
            cache_order.push_back(pb.coffset);
        }
        // FIFO-evict above cap; never the block the cursor sits in
        // (unordered_map values are pointer-stable, so only erase can
        // invalidate `blockp`).
        while (cache_bytes > cache_cap() && cache_order.size() > 1) {
            int64_t victim = cache_order.front();
            cache_order.pop_front();
            if (victim == block_coffset) {
                cache_order.push_back(victim);
                continue;
            }
            auto vit = cache.find(victim);
            if (vit != cache.end()) {
                cache_bytes -= vit->second.data.size();
                cache.erase(vit);
            }
        }
        return true;
    }

    // Load the block at compressed offset `coffset`; false at EOF/error.
    bool load_block(int64_t coffset) {
        auto it = cache.find(coffset);
        if (it == cache.end()) {
            // Random seeks (scattered mate fetches) read a small span;
            // sequential streaming (region scans) reads multi-megabyte
            // batches worth threading.
            int64_t span = (coffset == block_coffset + block_clen)
                               ? kBulkBytes : (128 << 10);
            if (!load_batch(coffset, span)) return false;
            it = cache.find(coffset);
            if (it == cache.end()) return false;
        }
        blockp = &it->second.data;
        block_coffset = coffset;
        block_clen = it->second.clen;
        within = 0;
        return true;
    }

    bool seek_virtual(int64_t voffset) {
        int64_t coffset = voffset >> 16;
        size_t w = voffset & 0xFFFF;
        if (coffset != block_coffset) {
            if (!load_block(coffset)) return false;
        }
        within = w;
        return true;
    }

    int64_t virtual_offset() const {
        // Normalise an at-end-of-block cursor to the NEXT block's start —
        // a 65536-byte uncompressed block would otherwise overflow the
        // 16-bit within field (mirrors io/bgzf.py::virtual_offset).
        if (blockp && within == blockp->size() && block_clen)
            return (block_coffset + (int64_t)block_clen) << 16;
        return (block_coffset << 16) | (int64_t)within;
    }

    // Read n bytes; returns bytes read (fewer only at EOF).
    size_t read(uint8_t* out, size_t n) {
        size_t done = 0;
        while (done < n) {
            if (!blockp || within >= blockp->size()) {
                int64_t next = (block_coffset < 0) ? 0 : block_coffset + block_clen;
                if (!load_block(next)) break;
                continue;  // skips zero-length (EOF marker) blocks naturally
            }
            size_t take = std::min(n - done, blockp->size() - within);
            memcpy(out + done, blockp->data() + within, take);
            within += take;
            done += take;
        }
        return done;
    }
};

// ---------------------------------------------------------------------------
// BAI
// ---------------------------------------------------------------------------

struct BaiRef {
    // bin id -> chunks
    std::vector<std::pair<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>>> bins;
    std::vector<uint64_t> linear;
};

struct BaiIndex {
    std::vector<BaiRef> refs;

    bool load(const char* path) {
        FILE* fh = fopen(path, "rb");
        if (!fh) return false;
        fseeko(fh, 0, SEEK_END);
        int64_t size = ftello(fh);
        fseeko(fh, 0, SEEK_SET);
        std::vector<uint8_t> data(size);
        if (fread(data.data(), 1, size, fh) != (size_t)size) {
            fclose(fh);
            return false;
        }
        fclose(fh);
        if (size < 8 || memcmp(data.data(), "BAI\x01", 4) != 0) return false;
        size_t off = 4;
        auto rd_i32 = [&](void) { int32_t v; memcpy(&v, data.data() + off, 4); off += 4; return v; };
        auto rd_u32 = [&](void) { uint32_t v; memcpy(&v, data.data() + off, 4); off += 4; return v; };
        auto rd_u64 = [&](void) { uint64_t v; memcpy(&v, data.data() + off, 8); off += 8; return v; };
        int32_t n_ref = rd_i32();
        refs.resize(n_ref);
        for (int r = 0; r < n_ref; r++) {
            int32_t n_bin = rd_i32();
            for (int b = 0; b < n_bin; b++) {
                uint32_t bin_id = rd_u32();
                int32_t n_chunk = rd_i32();
                std::vector<std::pair<uint64_t, uint64_t>> chunks(n_chunk);
                for (int c = 0; c < n_chunk; c++) {
                    uint64_t u = rd_u64(), v = rd_u64();
                    chunks[c] = {u, v};
                }
                refs[r].bins.push_back({bin_id, std::move(chunks)});
            }
            int32_t n_intv = rd_i32();
            refs[r].linear.resize(n_intv);
            for (int i = 0; i < n_intv; i++) refs[r].linear[i] = rd_u64();
        }
        return true;
    }

    std::vector<std::pair<uint64_t, uint64_t>> chunks_for_region(int ref_id, int64_t beg,
                                                                 int64_t end) const {
        std::vector<std::pair<uint64_t, uint64_t>> out;
        if (ref_id < 0 || ref_id >= (int)refs.size()) return out;
        const BaiRef& ref = refs[ref_id];
        uint64_t min_off = 0;
        if (!ref.linear.empty()) {
            size_t w = std::min((size_t)(beg >> 14), ref.linear.size() - 1);
            min_off = ref.linear[w];
        }
        // reg2bins
        std::vector<uint32_t> bins;
        bins.push_back(0);
        int64_t e = end - 1;
        int shifts[5] = {26, 23, 20, 17, 14};
        uint32_t offsets[5] = {1, 9, 73, 585, 4681};
        for (int level = 0; level < 5; level++) {
            for (int64_t k = offsets[level] + (beg >> shifts[level]);
                 k <= offsets[level] + (e >> shifts[level]); k++) {
                bins.push_back((uint32_t)k);
            }
        }
        for (const auto& [bin_id, chunks] : ref.bins) {
            if (bin_id == 37450) continue;
            if (std::find(bins.begin(), bins.end(), bin_id) == bins.end()) continue;
            for (auto [u, v] : chunks) {
                if (v > min_off) out.push_back({std::max(u, min_off), v});
            }
        }
        std::sort(out.begin(), out.end());
        std::vector<std::pair<uint64_t, uint64_t>> merged;
        for (auto [u, v] : out) {
            if (!merged.empty() && u <= merged.back().second) {
                merged.back().second = std::max(merged.back().second, v);
            } else {
                merged.push_back({u, v});
            }
        }
        return merged;
    }
};

const char SEQ_LOOKUP[17] = "=ACMGRSVTWYHKDBN";

// packed byte -> two decoded sequence characters (little-endian pair).
struct Nib2Table {
    uint16_t v[256];
    Nib2Table() {
        for (int b = 0; b < 256; b++)
            v[b] = (uint16_t)((uint8_t)SEQ_LOOKUP[b >> 4])
                 | ((uint16_t)((uint8_t)SEQ_LOOKUP[b & 0xF]) << 8);
    }
};
const Nib2Table NIB2;

constexpr uint32_t kConsumesRef = (1u << 0) | (1u << 2) | (1u << 3) | (1u << 7) | (1u << 8);

// Standard BAI bin for an alignment spanning [beg, end) (SAM spec §5.3).
// Alignment-safe u32 read: BAM record fields are byte-packed, so the
// cigar array is not necessarily 4-aligned within the record buffer.
inline uint32_t load_u32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

inline uint32_t reg2bin(int64_t beg, int64_t end) {
    --end;
    if (beg >> 14 == end >> 14) return (uint32_t)(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (uint32_t)(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (uint32_t)(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (uint32_t)(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (uint32_t)(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

// Flat structure-of-arrays batch: one growing buffer per field instead of
// three heap vectors per read (~1M small allocations per Mb otherwise).
struct BatchStore {
    std::vector<uint8_t> seq_flat, qual_flat;
    std::vector<int64_t> rq_off;      // per-read offset into seq/qual (N+1)
    std::vector<uint32_t> cigar_flat;
    std::vector<int64_t> cigar_off;   // N+1
    std::vector<int64_t> pos, end, mate_pos;
    std::vector<int32_t> rlen, mapq, flag, chrom_id, mate_chrom_id, insert_size;
    BatchStore() {
        rq_off.push_back(0);
        cigar_off.push_back(0);
    }
    size_t size() const { return rlen.size(); }
};

}  // namespace

extern "C" {

// Opaque fetch result handle.
struct PtpuBamBatch {
    BatchStore* store;
    int32_t max_len;
    int64_t n_cigar_total;
};

// Fetch all records overlapping [start, end) on ref_id.  Returns a handle
// (nullptr on failure); query sizes with ptpu_batch_dims, copy out with
// ptpu_batch_fill, release with ptpu_batch_free.
PtpuBamBatch* ptpu_bam_fetch(const char* bam_path, const char* bai_path,
                             int32_t want_ref, int64_t start, int64_t end,
                             int64_t first_record_voffset) {
    BgzfFile bg;
    if (!bg.open(bam_path)) return nullptr;
    BaiIndex bai;
    bool have_index = bai.load(bai_path);

    std::vector<std::pair<uint64_t, uint64_t>> chunks;
    if (have_index) {
        chunks = bai.chunks_for_region(want_ref, start, end);
    } else {
        chunks.push_back({(uint64_t)first_record_voffset, ~0ull});
    }

    auto* store = new BatchStore();
    int32_t max_len = 0;
    std::vector<uint8_t> rec;
    bool past_query = false;

    for (auto [u, v] : chunks) {
        if (past_query) break;
        if (!bg.seek_virtual((int64_t)u)) continue;
        while ((uint64_t)bg.virtual_offset() < v) {
            uint8_t size_bytes[4];
            if (bg.read(size_bytes, 4) < 4) break;
            int32_t block_size;
            memcpy(&block_size, size_bytes, 4);
            if (block_size <= 0) break;
            rec.resize(block_size);
            if (bg.read(rec.data(), block_size) < (size_t)block_size) break;

            int32_t ref_id, pos, l_seq, next_ref, next_pos, tlen;
            memcpy(&ref_id, rec.data() + 0, 4);
            memcpy(&pos, rec.data() + 4, 4);
            uint8_t l_read_name = rec[8];
            uint8_t mapq = rec[9];
            uint16_t n_cigar, flag;
            memcpy(&n_cigar, rec.data() + 12, 2);
            memcpy(&flag, rec.data() + 14, 2);
            memcpy(&l_seq, rec.data() + 16, 4);
            memcpy(&next_ref, rec.data() + 20, 4);
            memcpy(&next_pos, rec.data() + 24, 4);
            memcpy(&tlen, rec.data() + 28, 4);

            // Coordinate-sorted early exit: once the scan reaches a later
            // chromosome, the unplaced-unmapped tail (ref_id < 0), or a
            // record starting at/after `end` on want_ref, no later record
            // can overlap the query — stop the whole fetch instead of
            // decoding to the chunk/file end (critical for the no-index
            // full scan, where this turns O(file) tails into O(query)).
            if (ref_id < 0 || ref_id > want_ref ||
                (ref_id == want_ref && (int64_t)pos >= end)) {
                past_query = true;
                break;
            }
            if (ref_id < want_ref || l_seq == 0) continue;
            size_t off = 32 + l_read_name;
            const uint8_t* cigar_bytes = rec.data() + off;
            off += 4 * (size_t)n_cigar;
            const uint8_t* packed = rec.data() + off;
            off += (l_seq + 1) / 2;
            const uint8_t* qual = rec.data() + off;
            if (qual[0] == 0xFF) continue;

            int64_t ref_span = 0;
            for (int c = 0; c < n_cigar; c++) {
                uint32_t cv = load_u32(cigar_bytes + 4 * c);
                if (kConsumesRef & (1u << (cv & 0xF))) ref_span += cv >> 4;
            }
            // htslib bam_endpos: a zero-reference-span record still
            // occupies one base (placed-unmapped mate, fully soft-clipped).
            int64_t rec_end = (int64_t)pos + (ref_span > 0 ? ref_span : 1);
            if (rec_end <= start || pos >= end) continue;

            size_t so = store->seq_flat.size();
            store->seq_flat.resize(so + l_seq);
            uint8_t* sp = store->seq_flat.data() + so;
            {
                int i = 0;
                for (; i + 1 < l_seq; i += 2) {
                    uint16_t two = NIB2.v[packed[i / 2]];
                    sp[i] = (uint8_t)(two & 0xFF);
                    sp[i + 1] = (uint8_t)(two >> 8);
                }
                if (i < l_seq) sp[i] = (uint8_t)(NIB2.v[packed[i / 2]] & 0xFF);
            }
            store->qual_flat.insert(store->qual_flat.end(), qual, qual + l_seq);
            store->rq_off.push_back((int64_t)store->seq_flat.size());
            {
                size_t co = store->cigar_flat.size();
                store->cigar_flat.resize(co + n_cigar);
                if (n_cigar)
                    memcpy(store->cigar_flat.data() + co, cigar_bytes,
                           4 * (size_t)n_cigar);
            }
            store->cigar_off.push_back((int64_t)store->cigar_flat.size());
            int64_t adj_pos = pos;
            if (n_cigar > 0) {
                uint32_t c0 = load_u32(cigar_bytes);
                if ((c0 & 0xF) == 4) adj_pos -= c0 >> 4;
            }
            store->pos.push_back(adj_pos);
            store->end.push_back(rec_end);
            store->rlen.push_back(l_seq);
            store->mapq.push_back(mapq);
            store->flag.push_back(flag);
            store->chrom_id.push_back(ref_id);
            store->mate_chrom_id.push_back(next_ref);
            store->mate_pos.push_back(next_pos);
            store->insert_size.push_back(tlen);
            max_len = std::max(max_len, (int32_t)l_seq);
        }
        if (!have_index) break;  // full scan covers everything once
    }

    auto* batch = new PtpuBamBatch{store, max_len,
                                   (int64_t)store->cigar_flat.size()};
    return batch;
}

void ptpu_batch_dims(PtpuBamBatch* b, int64_t* n_reads, int32_t* max_len,
                     int64_t* n_cigar_total) {
    *n_reads = (int64_t)b->store->size();
    *max_len = b->max_len;
    *n_cigar_total = b->n_cigar_total;
}

void ptpu_batch_fill(PtpuBamBatch* b, uint8_t* seq, uint8_t* qual, int32_t* rlen,
                     int64_t* pos, int64_t* end, int32_t* mapq, int32_t* flag,
                     int32_t* chrom_id, int32_t* mate_chrom_id, int64_t* mate_pos,
                     int32_t* insert_size, uint32_t* cigar_flat, int64_t* cigar_off) {
    const BatchStore& st = *b->store;
    int64_t n = (int64_t)st.size();
    int32_t L = b->max_len;
    for (int64_t i = 0; i < n; i++) {
        int64_t o = st.rq_off[i];
        int64_t len = st.rq_off[i + 1] - o;
        memcpy(seq + i * L, st.seq_flat.data() + o, len);
        memcpy(qual + i * L, st.qual_flat.data() + o, len);
    }
    memcpy(rlen, st.rlen.data(), 4 * n);
    memcpy(pos, st.pos.data(), 8 * n);
    memcpy(end, st.end.data(), 8 * n);
    memcpy(mapq, st.mapq.data(), 4 * n);
    memcpy(flag, st.flag.data(), 4 * n);
    memcpy(chrom_id, st.chrom_id.data(), 4 * n);
    memcpy(mate_chrom_id, st.mate_chrom_id.data(), 4 * n);
    memcpy(mate_pos, st.mate_pos.data(), 8 * n);
    memcpy(insert_size, st.insert_size.data(), 4 * n);
    memcpy(cigar_flat, st.cigar_flat.data(), 4 * st.cigar_flat.size());
    memcpy(cigar_off, st.cigar_off.data(), 8 * (n + 1));
}

void ptpu_batch_free(PtpuBamBatch* b) {
    delete b->store;
    delete b;
}

// Build a standard .bai index for a coordinate-sorted BAM in one streaming
// pass (the role `samtools index` / htslib's sam_index_build plays for the
// reference, which refuses unindexed input).  Returns 0 on success,
// negative on open/parse/write failure.
int32_t ptpu_bam_index(const char* bam_path, const char* bai_path) {
    BgzfFile bg;
    if (!bg.open(bam_path)) return -1;
    uint8_t buf[4];
    if (bg.read(buf, 4) != 4 || memcmp(buf, "BAM\x01", 4) != 0) return -2;
    int32_t l_text;
    if (bg.read((uint8_t*)&l_text, 4) != 4 || l_text < 0) return -2;
    std::vector<uint8_t> skip((size_t)l_text);
    if (bg.read(skip.data(), skip.size()) != skip.size()) return -2;
    int32_t n_ref;
    if (bg.read((uint8_t*)&n_ref, 4) != 4 || n_ref < 0) return -2;
    for (int32_t r = 0; r < n_ref; r++) {
        int32_t l_name;
        if (bg.read((uint8_t*)&l_name, 4) != 4 || l_name < 0) return -2;
        skip.resize((size_t)l_name + 4);
        if (bg.read(skip.data(), skip.size()) != skip.size()) return -2;
    }

    struct RefIdx {
        std::unordered_map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>> bins;
        std::vector<uint64_t> linear;
    };
    std::vector<RefIdx> refs((size_t)n_ref);
    std::vector<uint8_t> rec;
    int32_t last_ref = -1;
    int64_t last_pos = -1;
    while (true) {
        int64_t u = bg.virtual_offset();
        if (bg.read(buf, 4) < 4) break;
        int32_t block_size;
        memcpy(&block_size, buf, 4);
        if (block_size <= 0) break;
        rec.resize((size_t)block_size);
        if (bg.read(rec.data(), rec.size()) < rec.size()) break;
        int64_t v = bg.virtual_offset();

        int32_t ref_id, pos;
        memcpy(&ref_id, rec.data() + 0, 4);
        memcpy(&pos, rec.data() + 4, 4);
        if (ref_id < 0 || ref_id >= n_ref || pos < 0) continue;
        // A BAI is only meaningful for a coordinate-sorted file; refuse to
        // index disorder (the fetch early-exit would drop reads otherwise).
        if (ref_id < last_ref || (ref_id == last_ref && pos < last_pos)) return -5;
        last_ref = ref_id;
        last_pos = pos;
        uint8_t l_read_name = rec[8];
        uint16_t n_cigar;
        memcpy(&n_cigar, rec.data() + 12, 2);
        const uint8_t* cigar_bytes = rec.data() + 32 + l_read_name;
        int64_t span = 0;
        for (int c = 0; c < n_cigar; c++) {
            uint32_t cv = load_u32(cigar_bytes + 4 * c);
            if (kConsumesRef & (1u << (cv & 0xF))) span += cv >> 4;
        }
        int64_t rend = pos + (span > 0 ? span : 1);

        RefIdx& R = refs[(size_t)ref_id];
        auto& ch = R.bins[reg2bin(pos, rend)];
        if (!ch.empty() && ch.back().second == (uint64_t)u) {
            ch.back().second = (uint64_t)v;  // extend the adjacent chunk
        } else {
            ch.push_back({(uint64_t)u, (uint64_t)v});
        }
        size_t wbeg = (size_t)(pos >> 14), wend = (size_t)((rend - 1) >> 14);
        if (R.linear.size() <= wend) R.linear.resize(wend + 1, 0);
        for (size_t w = wbeg; w <= wend; w++) {
            if (R.linear[w] == 0) R.linear[w] = (uint64_t)u;
        }
    }
    // Forward-fill empty linear-index windows with the preceding offset so a
    // query landing in a readless window still seeks near its position.
    for (auto& R : refs) {
        uint64_t last = 0;
        for (auto& x : R.linear) {
            if (x == 0) x = last;
            else last = x;
        }
    }

    FILE* out = fopen(bai_path, "wb");
    if (!out) return -3;
    bool ok = fwrite("BAI\x01", 1, 4, out) == 4 && fwrite(&n_ref, 4, 1, out) == 1;
    for (auto& R : refs) {
        std::vector<uint32_t> ids;
        ids.reserve(R.bins.size());
        for (auto& kv : R.bins) ids.push_back(kv.first);
        std::sort(ids.begin(), ids.end());  // deterministic output
        int32_t n_bin = (int32_t)ids.size();
        ok = ok && fwrite(&n_bin, 4, 1, out) == 1;
        for (uint32_t id : ids) {
            auto& ch = R.bins[id];
            int32_t n_chunk = (int32_t)ch.size();
            ok = ok && fwrite(&id, 4, 1, out) == 1 &&
                 fwrite(&n_chunk, 4, 1, out) == 1;
            for (auto [cu, cv] : ch) {
                ok = ok && fwrite(&cu, 8, 1, out) == 1 && fwrite(&cv, 8, 1, out) == 1;
            }
        }
        int32_t n_intv = (int32_t)R.linear.size();
        ok = ok && fwrite(&n_intv, 4, 1, out) == 1;
        if (n_intv) {
            ok = ok && fwrite(R.linear.data(), 8, (size_t)n_intv, out) == (size_t)n_intv;
        }
    }
    if (fclose(out) != 0) ok = false;
    return ok ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Read QC trimming (cwindow.pyx:416-479 semantics) — in-place over the SoA.
// ---------------------------------------------------------------------------

void ptpu_trim_reads(int64_t n_reads, int32_t max_len, uint8_t* qual,
                     const int32_t* rlen, const int32_t* flag,
                     const int32_t* insert_size, const uint32_t* cigar_flat,
                     const int64_t* cigar_off, const uint8_t* good_mask,
                     int32_t trim_read_flank, int32_t trim_overlapping,
                     int32_t trim_adapter, int32_t trim_soft_clipped) {
    const int32_t FLAG_PAIRED = 1, FLAG_REVERSE = 16, FLAG_MREVERSE = 32;
    for (int64_t i = 0; i < n_reads; i++) {
        if (!good_mask[i]) continue;
        uint8_t* q = qual + i * max_len;
        int32_t rl = rlen[i];
        int32_t fl = flag[i];
        bool reverse = fl & FLAG_REVERSE;

        if (!reverse) {
            for (int32_t k = 1; k <= rl; k++) {
                if (k < trim_read_flank || q[rl - k] < 5) q[rl - k] = 0;
                else break;
            }
        } else {
            for (int32_t k = 0; k < rl; k++) {
                if (k < trim_read_flank || q[k] < 5) q[k] = 0;
                else break;
            }
        }

        int32_t ins = insert_size[i];
        int32_t abs_ins = ins < 0 ? -ins : ins;
        bool paired = fl & FLAG_PAIRED;

        if (trim_overlapping && paired && abs_ins > 0 && !reverse &&
            (fl & FLAG_MREVERSE) && abs_ins < 2 * rl) {
            int32_t n_zero = std::min(rl, 2 * rl - ins + 1);
            for (int32_t k = 1; k <= n_zero; k++) q[rl - k] = 0;
        }

        if (trim_adapter && paired && abs_ins > 0 && abs_ins < rl) {
            for (int32_t k = abs_ins; k < rl; k++) q[k] = 0;
        }

        if (trim_soft_clipped) {
            int32_t idx = 0;
            for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
                uint32_t op = cigar_flat[c] & 0xF;
                int32_t ln = (int32_t)(cigar_flat[c] >> 4);
                if (op == 0 || op == 1) {
                    idx += ln;
                } else if (op == 4) {
                    for (int32_t k = 0; k < ln && idx < rl; k++, idx++) q[idx] = 0;
                }
            }
        }
    }
}

}  // extern "C"
