// Native colored de Bruijn assembler.
//
// Same semantics as the Python implementation in
// platypus_tpu_torch/candidates/assembly.py (which mirrors the reference
// assembler.pyx and stays as the parity oracle): insertion-ordered nodes,
// REF/READ colour merging, 4-out-edge cap with accumulating weights,
// per-start-node DFS bubble walk with a 20-path cap, per-path cycle check,
// weight-thresholded extension, and context-trimmed variant extraction.
//
// C ABI, loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

constexpr int REF = 1;
constexpr int READ = 2;
constexpr int REF_AND_READ = 3;
constexpr int MAX_EDGES = 4;
constexpr int MAX_PATHS = 20;

struct Node {
    const char* kmer;  // points into the owning Graph's arena
    int colours;
    int64_t position;
    double weight;
    // (target node index, weight)
    int n_edges = 0;
    int32_t edge_to[MAX_EDGES];
    double edge_w[MAX_EDGES];
};

// Open-addressing node index keyed by raw k-mer bytes.  Sequences are
// interned into an arena once per load call, so node keys are pointers —
// no per-insert string allocation, equality is one memcmp, and the table
// is a flat power-of-two vector with linear probing.
struct Graph {
    int kmer_size;
    std::vector<Node> nodes;  // insertion order (bubble scan relies on it)
    std::vector<int32_t> table = std::vector<int32_t>(16384, -1);
    uint64_t mask = 16383;
    std::deque<std::string> arena;

    const char* intern(const char* seq, int64_t len) {
        arena.emplace_back(seq, seq + len);
        return arena.back().data();
    }

    uint64_t hash_kmer(const char* p) const {
        uint64_t h = 1469598103934665603ULL;
        int i = 0;
        for (; i + 8 <= kmer_size; i += 8) {
            uint64_t v;
            memcpy(&v, p + i, 8);
            h = (h ^ v) * 1099511628211ULL;
        }
        if (i < kmer_size) {
            uint64_t v = 0;
            memcpy(&v, p + i, kmer_size - i);
            h = (h ^ v) * 1099511628211ULL;
        }
        h ^= h >> 29;
        return h;
    }

    void grow() {
        size_t cap = table.size() * 2;
        table.assign(cap, -1);
        mask = cap - 1;
        for (int32_t id = 0; id < (int32_t)nodes.size(); id++) {
            uint64_t h = hash_kmer(nodes[id].kmer) & mask;
            while (table[h] != -1) h = (h + 1) & mask;
            table[h] = id;
        }
    }

    // `kmer` MUST point into this graph's arena (interned by the caller).
    int32_t insert_or_update(const char* kmer, int colours, int64_t position,
                             double weight) {
        if ((nodes.size() + 1) * 10 >= table.size() * 7) grow();
        uint64_t h = hash_kmer(kmer) & mask;
        for (;;) {
            int32_t id = table[h];
            if (id == -1) {
                id = (int32_t)nodes.size();
                Node n;
                n.kmer = kmer;
                n.colours = colours;
                n.position = position;
                n.weight = weight;
                nodes.push_back(n);
                table[h] = id;
                return id;
            }
            if (memcmp(nodes[id].kmer, kmer, kmer_size) == 0) {
                Node& n = nodes[id];
                n.colours |= colours;
                n.weight += weight;
                return id;
            }
            h = (h + 1) & mask;
        }
    }

    // Consecutive k-mers of one sequence share node b(i) == a(i+1): the
    // caller threads `prev` through and the left endpoint skips its hash
    // lookup, applying the same colour/weight accumulation directly
    // (position is only set at node creation, so nothing else differs).
    void add_edge_chained(int32_t& prev, const char* k1, const char* k2,
                          int colours, int64_t p1, int64_t p2, double weight) {
        int32_t a;
        if (prev >= 0) {
            Node& pn = nodes[prev];
            pn.colours |= colours;
            pn.weight += weight;
            a = prev;
        } else {
            a = insert_or_update(k1, colours, p1, weight);
        }
        int32_t b = insert_or_update(k2, colours, p2, weight);
        prev = b;
        Node& n = nodes[a];
        for (int i = 0; i < n.n_edges; i++) {
            if (n.edge_to[i] == b) {
                n.edge_w[i] += weight;
                return;
            }
        }
        if (n.n_edges < MAX_EDGES) {
            n.edge_to[n.n_edges] = b;
            n.edge_w[n.n_edges] = weight;
            n.n_edges++;
        }
    }
};

struct VariantOut {
    int64_t pos;
    std::string removed;
    std::string added;
};

struct AsmHandle {
    Graph graph;
    std::vector<VariantOut> variants;
    std::string packed;          // removed\0added\0 per variant
    std::vector<int64_t> pos_out;
    std::vector<int64_t> off_out;
};

// DFS continuation (assembly.py::_variant_paths_from_node).  Returns false
// when the 20-path cap trips (discard all paths from this start node).
bool variant_paths(const Graph& g, std::vector<int32_t> start_path,
                   double min_weight,
                   std::vector<std::vector<int32_t>>& finished) {
    std::vector<std::vector<int32_t>> stack;
    stack.push_back(std::move(start_path));
    while (!stack.empty()) {
        std::vector<int32_t> path = std::move(stack.back());
        stack.pop_back();
        if ((int)stack.size() + 1 > MAX_PATHS || (int)finished.size() + 1 > MAX_PATHS) {
            return false;
        }
        // cycle check
        {
            std::unordered_set<int32_t> seen(path.begin(), path.end());
            if (seen.size() != path.size()) continue;
        }
        const Node& end = g.nodes[path.back()];
        if (end.colours == REF_AND_READ) {
            finished.push_back(std::move(path));
        } else if (end.colours == REF) {
            continue;
        } else {
            for (int i = 0; i < end.n_edges; i++) {
                const Node& child = g.nodes[end.edge_to[i]];
                if (end.edge_w[i] >= min_weight || child.colours == REF_AND_READ ||
                    child.colours == REF) {
                    std::vector<int32_t> np = path;
                    np.push_back(end.edge_to[i]);
                    stack.push_back(std::move(np));
                }
            }
        }
    }
    return true;
}

bool extract_variant(const Graph& g, const std::vector<int32_t>& path,
                     const char* ref_seq, int64_t ref_len, int64_t ref_start,
                     VariantOut& out) {
    const Node& start = g.nodes[path.front()];
    const Node& end = g.nodes[path.back()];
    int64_t start_pos = start.position;
    int64_t end_pos = end.position;
    if (end_pos < start_pos) return false;

    std::string read_seq;
    read_seq.reserve(path.size());
    for (int32_t id : path) read_seq.push_back(g.nodes[id].kmer[0]);

    int64_t lo = start_pos - ref_start;
    int64_t hi = end_pos - ref_start + 1;
    lo = std::max<int64_t>(0, lo);
    hi = std::min(hi, ref_len);
    std::string this_ref(ref_seq + lo, ref_seq + std::max(lo, hi));

    while (!read_seq.empty() && !this_ref.empty() &&
           this_ref.back() == read_seq.back()) {
        this_ref.pop_back();
        read_seq.pop_back();
    }
    size_t f = 0;
    while (f < read_seq.size() && f < this_ref.size() &&
           this_ref[f] == read_seq[f]) {
        f++;
    }
    start_pos += (int64_t)f;
    out.pos = start_pos;
    out.removed = this_ref.substr(f);
    out.added = read_seq.substr(f);
    return true;
}

}  // namespace

extern "C" {

AsmHandle* ptpu_asm_create(int kmer_size) {
    auto* h = new AsmHandle();
    h->graph.kmer_size = kmer_size;
    return h;
}

void ptpu_asm_free(AsmHandle* h) { delete h; }

void ptpu_asm_load_reference(AsmHandle* h, const char* ref_seq, int64_t len,
                             int64_t ref_start) {
    int k = h->graph.kmer_size;
    if (len < k + 2) return;
    const char* base = h->graph.intern(ref_seq, len);
    int32_t prev = -1;
    for (int64_t i = 0; i < len - k - 1; i++) {
        h->graph.add_edge_chained(prev, base + i, base + i + 1, REF,
                                  ref_start + i, ref_start + i + 1, 1.0);
    }
}

void ptpu_asm_load_read(AsmHandle* h, const uint8_t* seq, const uint8_t* qual,
                        int32_t rlen, int32_t min_qual) {
    int k = h->graph.kmer_size;
    int w = k + 1;  // window [i, i+k] gates the edge's two k-mers
    int64_t n = (int64_t)rlen - k - 1;
    if (n <= 0) return;
    int64_t m = n + k;  // qual indices touched by any window

    // Sliding-window minimum via per-block suffix mins + running prefix min
    // (O(1) per position instead of O(k)).
    thread_local std::vector<uint8_t> sufmin;
    sufmin.resize((size_t)m);
    for (int64_t bstart = 0; bstart < m; bstart += w) {
        int64_t bend = std::min<int64_t>(bstart + w, m);
        uint8_t mn = qual[bend - 1];
        sufmin[bend - 1] = mn;
        for (int64_t j = bend - 2; j >= bstart; j--) {
            mn = std::min(mn, qual[j]);
            sufmin[j] = mn;
        }
    }

    const bool any_n = memchr(seq, 'N', (size_t)m) != nullptr;
    int ncnt = 0;
    if (any_n) {
        for (int j = 0; j <= k; j++) ncnt += (seq[j] == 'N');
    }

    const char* base = h->graph.intern((const char*)seq, (int64_t)rlen);
    int32_t prev = -1;
    uint8_t pre = 255;
    for (int64_t i = 0; i < n; i++) {
        int64_t r = i + k;
        pre = (r % w == 0) ? qual[r] : std::min(pre, qual[r]);
        int min_q = std::min(sufmin[i], pre);
        if (min_q >= min_qual && ncnt == 0) {
            h->graph.add_edge_chained(prev, base + i, base + i + 1, READ, -1,
                                      -1, (double)min_q);
        } else {
            prev = -1;  // window gap: the chain is broken
        }
        if (any_n && i + 1 < n) {
            ncnt -= (seq[i] == 'N');
            ncnt += (seq[i + w] == 'N');
        }
    }
}

int32_t ptpu_asm_detect_cycles(AsmHandle* h) {
    const Graph& g = h->graph;
    std::vector<uint8_t> colour(g.nodes.size(), 0);  // 0 white 1 grey 2 black
    std::vector<std::pair<int32_t, int>> stack;
    for (int32_t root = 0; root < (int32_t)g.nodes.size(); root++) {
        if (colour[root] != 0) continue;
        stack.clear();
        stack.push_back({root, 0});
        colour[root] = 1;
        while (!stack.empty()) {
            auto& [node, ei] = stack.back();
            const Node& n = g.nodes[node];
            if (ei < n.n_edges) {
                int32_t child = n.edge_to[ei];
                ei++;
                if (colour[child] == 1) return 1;
                if (colour[child] == 0) {
                    colour[child] = 1;
                    stack.push_back({child, 0});
                }
            } else {
                colour[node] = 2;
                stack.pop_back();
            }
        }
    }
    return 0;
}

// Find bubbles; results retrievable via ptpu_asm_results.
int64_t ptpu_asm_find_bubbles(AsmHandle* h, double min_weight,
                              const char* ref_seq, int64_t ref_len,
                              int64_t ref_start, int64_t assem_start,
                              int64_t assem_end) {
    Graph& g = h->graph;
    h->variants.clear();
    for (int32_t ni = 0; ni < (int32_t)g.nodes.size(); ni++) {
        const Node& node = g.nodes[ni];
        if (node.colours != REF_AND_READ) continue;
        if (node.position < assem_start || node.position >= assem_end) continue;
        for (int e = 0; e < node.n_edges; e++) {
            const Node& child = g.nodes[node.edge_to[e]];
            if (child.colours != READ) continue;
            std::vector<std::vector<int32_t>> finished;
            std::vector<int32_t> path = {ni, node.edge_to[e]};
            if (!variant_paths(g, std::move(path), min_weight, finished)) continue;
            for (const auto& p : finished) {
                VariantOut v;
                if (extract_variant(g, p, ref_seq, ref_len, ref_start, v)) {
                    h->variants.push_back(std::move(v));
                }
            }
        }
    }
    // Pack output.
    h->packed.clear();
    h->pos_out.clear();
    h->off_out.clear();
    h->off_out.push_back(0);
    for (const auto& v : h->variants) {
        h->pos_out.push_back(v.pos);
        h->packed += v.removed;
        h->packed.push_back('\0');
        h->packed += v.added;
        h->packed.push_back('\0');
        h->off_out.push_back((int64_t)h->packed.size());
    }
    return (int64_t)h->variants.size();
}

void ptpu_asm_results(AsmHandle* h, int64_t* pos, int64_t* offsets,
                      char* packed) {
    memcpy(pos, h->pos_out.data(), h->pos_out.size() * sizeof(int64_t));
    memcpy(offsets, h->off_out.data(), h->off_out.size() * sizeof(int64_t));
    memcpy(packed, h->packed.data(), h->packed.size());
}

int64_t ptpu_asm_packed_size(AsmHandle* h) { return (int64_t)h->packed.size(); }

}  // extern "C"

extern "C" {

// Batched read loading: seq/qual are [n, max_len] row-major; rows[idx]
// selects reads.  Equivalent to calling ptpu_asm_load_read per row.
void ptpu_asm_load_reads(AsmHandle* h, const uint8_t* seq, const uint8_t* qual,
                         int32_t max_len, const int32_t* rlen,
                         const int64_t* rows, int64_t n_rows,
                         int32_t min_qual) {
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t i = rows[r];
        ptpu_asm_load_read(h, seq + i * max_len, qual + i * max_len, rlen[i],
                           min_qual);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-region assembly: the tile loop of
// candidates/assembly.py::assemble_region_variants runs here in ONE ctypes
// call — tile graphs are independent, so tiles fan out over a small native
// thread pool, and the Python<->C crossing cost drops from ~5 calls/tile to
// 1 call/region.  Per-tile results are emitted in tile order (discovery
// order within a tile), matching the sequential path exactly.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

namespace {

struct RegionHandle {
    std::vector<int64_t> tile_counts;
    std::vector<int64_t> pos_out;
    std::vector<int64_t> off_out;
    std::string packed;
};

struct PileView {
    const uint8_t* seq;
    const uint8_t* qual;
    int64_t stride;
    const int32_t* rlen;
    const uint8_t* qc_fail;
};

// One tile: build graph (with cycle k-escalation), find bubbles.
// Mirrors assembly.py::assemble_reads_and_detect_variants.
std::vector<VariantOut> run_region_tile(
    int kmer_size, int32_t min_qual, double min_weight, int32_t no_cycles,
    const char* ref_seq, int64_t ref_len, int64_t ref_start,
    int64_t assem_start, int64_t assem_end,
    const std::vector<PileView>& piles, const int64_t* slice_bounds) {
    int k = kmer_size;
    for (;;) {
        AsmHandle h;
        h.graph.kmer_size = k;
        ptpu_asm_load_reference(&h, ref_seq, ref_len, ref_start);
        for (size_t p = 0; p < piles.size(); p++) {
            const PileView& pv = piles[p];
            int64_t lo = slice_bounds[2 * p], hi = slice_bounds[2 * p + 1];
            for (int64_t i = lo; i < hi; i++) {
                if (pv.qc_fail[i]) continue;
                ptpu_asm_load_read(&h, pv.seq + i * pv.stride,
                                   pv.qual + i * pv.stride, pv.rlen[i],
                                   min_qual);
            }
        }
        if (no_cycles && ptpu_asm_detect_cycles(&h)) {
            if (k > 50) return {};
            k += 5;
            continue;
        }
        ptpu_asm_find_bubbles(&h, min_weight, ref_seq, ref_len, ref_start,
                              assem_start, assem_end);
        return std::move(h.variants);
    }
}

}  // namespace

extern "C" {

// slices layout: [n_tiles][n_piles][2] (start, stop) row bounds per pile.
// Pointer arrays are passed as uint64 addresses (one per pile).
RegionHandle* ptpu_asm_region(
    int32_t kmer_size, int32_t min_qual, double min_weight, int32_t no_cycles,
    int32_t n_threads, const char* region_ref, int64_t n_tiles,
    const int64_t* assem_start, const int64_t* assem_end,
    const int64_t* ref_start_coord, const int64_t* ref_off,
    const int64_t* ref_len, int64_t n_piles, const uint64_t* seq_ptrs,
    const uint64_t* qual_ptrs, const int64_t* seq_strides,
    const uint64_t* rlen_ptrs, const uint64_t* qcfail_ptrs,
    const int64_t* slices, int64_t* tile_counts_out) {
    std::vector<PileView> piles((size_t)n_piles);
    for (int64_t p = 0; p < n_piles; p++) {
        piles[p] = PileView{
            (const uint8_t*)(uintptr_t)seq_ptrs[p],
            (const uint8_t*)(uintptr_t)qual_ptrs[p],
            seq_strides[p],
            (const int32_t*)(uintptr_t)rlen_ptrs[p],
            (const uint8_t*)(uintptr_t)qcfail_ptrs[p],
        };
    }

    std::vector<std::vector<VariantOut>> per_tile((size_t)n_tiles);
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        for (;;) {
            int64_t t = next.fetch_add(1);
            if (t >= n_tiles) return;
            per_tile[t] = run_region_tile(
                kmer_size, min_qual, min_weight, no_cycles,
                region_ref + ref_off[t], ref_len[t], ref_start_coord[t],
                assem_start[t], assem_end[t], piles,
                slices + t * n_piles * 2);
        }
    };
    int nt = std::max(1, std::min<int>(n_threads, (int)n_tiles));
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nt);
        for (int i = 0; i < nt; i++) threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }

    auto* rh = new RegionHandle();
    rh->off_out.push_back(0);
    for (int64_t t = 0; t < n_tiles; t++) {
        tile_counts_out[t] = (int64_t)per_tile[t].size();
        rh->tile_counts.push_back(tile_counts_out[t]);
        for (const auto& v : per_tile[t]) {
            rh->pos_out.push_back(v.pos);
            rh->packed += v.removed;
            rh->packed.push_back('\0');
            rh->packed += v.added;
            rh->packed.push_back('\0');
            rh->off_out.push_back((int64_t)rh->packed.size());
        }
    }
    return rh;
}

int64_t ptpu_asm_region_packed_size(RegionHandle* h) {
    return (int64_t)h->packed.size();
}

void ptpu_asm_region_results(RegionHandle* h, int64_t* pos, int64_t* offsets,
                             char* packed) {
    memcpy(pos, h->pos_out.data(), h->pos_out.size() * sizeof(int64_t));
    memcpy(offsets, h->off_out.data(), h->off_out.size() * sizeof(int64_t));
    memcpy(packed, h->packed.data(), h->packed.size());
}

void ptpu_asm_region_free(RegionHandle* h) { delete h; }

}  // extern "C"
