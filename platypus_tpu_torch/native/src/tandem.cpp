// Native tandem-repeat annotator.
//
// Same semantics as the Python implementation in
// platypus_tpu_torch/models/error_model.py::calculate_size_and_displacement
// (which mirrors the reference tandem.c annotate() and is the parity
// oracle): per-base (repeat tract length, unit size) with the 64-nt scan
// window caps, N pseudo-randomisation, indel-rate acceptance rule and
// ascending (pos-block, unit) update order.
//
// C ABI, loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int MAX_UNIT_LENGTH = 12;
constexpr int MIN_PARTIAL_MATCH = 5;

inline int approximate_indel_rate(int size, int displacement) {
    if (displacement == 1) return -360 + 24 * size;
    if (displacement == 2) return -327 + 15 * size;
    if (displacement == 3) return -291 + 8 * size;
    return -282 + 6 * size;
}

// A/C/G/T -> 0..3; other chars -> position-dependent pseudo-random;
// beyond-end -> 0 ('A').
inline void encode_two_bit(const uint8_t* seq, int64_t n, int64_t total,
                           std::vector<int8_t>& out) {
    out.assign(total, 0);
    for (int64_t i = 0; i < n; i++) {
        switch (seq[i] & 0xDF) {
            case 'A': out[i] = 0; break;
            case 'C': out[i] = 1; break;
            case 'G': out[i] = 2; break;
            case 'T': out[i] = 3; break;
            default: {
                int64_t m = i % 257;
                out[i] = (int8_t)(((m * (1 + m)) / 2 + (i % 5)) % 4);
            }
        }
    }
}

}  // namespace

extern "C" {

void ptpu_tandem_annotate(const uint8_t* seq, int64_t length,
                          int32_t annotate_all, int32_t* sizes,
                          int32_t* disps) {
    for (int64_t i = 0; i < length; i++) {
        sizes[i] = 1;
        disps[i] = 1;
    }
    if (length == 0) return;

    std::vector<int8_t> code;
    encode_two_bit(seq, length, length + 64 + MAX_UNIT_LENGTH + 4, code);

    // Per unit-length d: run[i] = #consecutive positions with
    // code[i + k] == code[i + d + k].
    const int64_t n_cmp = length + 64;
    std::vector<int32_t> runs((MAX_UNIT_LENGTH - 1) * (n_cmp + 1), 0);
    for (int d = 1; d < MAX_UNIT_LENGTH; d++) {
        int32_t* run = runs.data() + (int64_t)(d - 1) * (n_cmp + 1);
        run[n_cmp] = 0;
        for (int64_t i = n_cmp - 1; i >= 0; i--) {
            run[i] = (code[i] == code[i + d]) ? run[i + 1] + 1 : 0;
        }
    }

    auto foundmatch = [&](int64_t p, int size, int d) {
        if (p + d + size > length) size = (int)(length - d - p);
        size += d;
        if (size < d + std::min(MIN_PARTIAL_MATCH, d)) return;
        if (approximate_indel_rate(sizes[p], disps[p]) <
            approximate_indel_rate(size, d)) {
            sizes[p] = size;
            disps[p] = d;
            if (annotate_all) {
                int64_t hi = std::min(length, p + size);
                for (int64_t i = p + 1; i < hi; i++) {
                    sizes[i] = size;
                    disps[i] = d;
                }
            }
        }
    };

    for (int64_t pos = 0; pos < length; pos += 4) {
        for (int d = 1; d < MAX_UNIT_LENGTH; d++) {
            if (pos + d >= length) break;
            const int32_t* run = runs.data() + (int64_t)(d - 1) * (n_cmp + 1);
            bool near_end = pos + d + 32 >= length;
            for (int j = 0; j < 4; j++) {
                int64_t p = pos + j;
                if (p >= length) break;
                int cap = near_end ? (32 - j) : (64 - j);
                foundmatch(p, std::min(run[p], cap), d);
            }
        }
    }
}

// Per-base phred gap-open from the homopolymer run-length table
// (chaplotype.pyx:552-590 semantics: value = table[min(run_end - i, cap)]
// where run_end is the last index of the homopolymer run containing i and
// N breaks runs on both sides).  Pure integer table lookups — exact by
// construction vs the numpy oracle in models/error_model.py.
void ptpu_gap_open(const uint8_t* seq, int64_t n, const int32_t* table,
                   int32_t table_len, int32_t* out) {
    const int64_t cap = table_len - 1;
    int64_t run_end = n - 1;
    for (int64_t i = n - 1; i >= 0; --i) {
        uint8_t c = seq[i];
        if (i < n - 1) {
            uint8_t nxt = seq[i + 1];
            if (c != nxt || c == 'N' || nxt == 'N') run_end = i;
        }
        int64_t len = run_end - i;
        if (len > cap) len = cap;
        out[i] = table[len];
    }
}

}  // extern "C"
