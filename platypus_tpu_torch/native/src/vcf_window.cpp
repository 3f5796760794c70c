// One called window's VCF data lines in one call: the INFO values, the
// FILTER field, every sample's genotype fields and the line text, byte for
// byte as the Python route of platypus_tpu_torch/vcfout/records.py
// (output_call_to_vcf's fallback body: compute_vcf_info, compute_vcf_filter,
// ref_and_alt, trim_left_padding, the per-sample loop) and
// vcfout/writer.py VCFWriter.write_record write them (vcfutils.pyx:338-599,
// 1226-1627).
//
// The byte contract rests on Python's float semantics, reproduced here:
// the same libm (log, log10, exp, pow, sqrt; called so that the compiler
// folds none of them), Python's operand order, min/max that keep the first
// argument unless the second is strictly better, round_ref's ties away
// from zero on the exact binary value, "%.12g" plus ".0" on integral values
// (_py2_float_str), "%.0f" / "%1.4f".  Where the Python route would raise
// (a division by zero, an infinite value rounded or made an int, a
// non-ASCII base), the entry writes nothing and returns status 1: the
// caller then runs the Python route, which raises as before.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "vcf_parts.h"

namespace {

// libm through pointers the compiler cannot see through, so a call with a
// constant argument is not folded (at compile time, correctly rounded)
// where CPython calls the library at run time.
double (*volatile c_log)(double) = std::log;
double (*volatile c_log10)(double) = std::log10;
double (*volatile c_exp)(double) = std::exp;
double (*volatile c_pow)(double, double) = std::pow;

// Python's max(a, b) / min(a, b): the first unless the second is strictly
// larger / smaller (so a NaN second argument loses).
inline double py_max(double a, double b) { return b > a ? b : a; }
inline double py_min(double a, double b) { return b < a ? b : a; }

// ---------------------------------------------------------------------------
// utils/maths.py: log_factorial, log_beta, _three_f_two, beta_binomial_cdf
// ---------------------------------------------------------------------------

const double kTwoPi = 2.0 * 3.141592653589793;
const double kLog10E = 0.43429448190325182;  // records.LOG10E

double log_factorial(int64_t x) {
    if (x < 15) {
        double ans = 0.0;
        for (int64_t i = 1; i <= x; ++i) ans += c_log((double)i);
        return ans;
    }
    const double y = (double)x;
    return y * c_log(y) + c_log(kTwoPi * y) / 2.0 - y
           + c_pow(y, -1.0) / 12.0 - c_pow(y, -3.0) / 360.0
           + c_pow(y, -5.0) / 1260.0 - c_pow(y, -7.0) / 1680.0
           + c_pow(y, -9.0) / 1188.0;
}

double log_beta(int64_t x, int64_t y) {
    return log_factorial(x - 1) + log_factorial(y - 1)
           - log_factorial(x + y - 1);
}

double three_f_two(int64_t k, int64_t n, int64_t alpha, int64_t beta) {
    const double a_2 = (double)(alpha + k) + 1.0;
    const double a_3 = (double)(k - n) + 1.0;
    const double b_1 = (double)k + 2.0;
    const double b_2 = (double)(-beta - n + k) + 2.0;
    double the_sum = 1.0, last_term = 1.0;
    const int64_t m = k - n + 1 < 0 ? n - k - 1 : k - n + 1;
    for (int64_t i = 1; i <= m; ++i) {
        const double di = (double)i;
        const double new_term = last_term * (a_2 + di - 1.0)
                                * (a_3 + di - 1.0)
                                / ((b_1 + di - 1.0) * (b_2 + di - 1.0));
        the_sum += new_term;
        last_term = new_term;
    }
    return the_sum;
}

double beta_binomial_cdf(int64_t k, int64_t n, int64_t alpha, int64_t beta) {
    if (k == n) return 1.0;
    const double numerator = log_beta(beta + n - k - 1, alpha + k + 1)
                             + c_log(three_f_two(k, n, alpha, beta));
    const double denominator = log_beta(alpha, beta) + log_beta(n - k, k + 2)
                               + c_log((double)(n + 1));
    return py_max(1e-30, 1.0 - c_exp(numerator - denominator));
}

// records.py allele_bias_pvalue / strand_bias_pvalue.
double allele_bias_pvalue(int64_t total_reads, int64_t variant_reads) {
    if (total_reads > 0 && (double)variant_reads / (double)total_reads >= 0.5)
        return 1.0;
    if (total_reads == 0) return 1.0;
    const double p = beta_binomial_cdf(variant_reads, total_reads, 20, 20);
    return py_min(p, 1.0 - p);
}

double strand_bias_pvalue(int64_t n_fwd, int64_t n_rev, int64_t n_fwd_var,
                          int64_t n_rev_var) {
    if (n_fwd == 0 || n_rev == 0) return 1.0;
    const bool use_forward = n_fwd >= n_rev;
    if (n_fwd + n_rev > 0 && n_fwd_var + n_rev_var > 0) {
        const double freq = (double)(use_forward ? n_fwd : n_rev)
                            / (double)(n_fwd + n_rev);
        int64_t alpha, beta;
        if (freq < 0.5) {
            alpha = 20;
            beta = (int64_t)(20.0 / freq - 20.0);
        } else if (freq > 0.5) {
            beta = 20;
            alpha = (int64_t)(20.0 * freq / (1.0 - freq));
        } else {
            alpha = beta = 20;
        }
        const int64_t k = use_forward ? n_fwd_var : n_rev_var;
        return beta_binomial_cdf(k, n_fwd_var + n_rev_var, alpha, beta);
    }
    return 1.0;
}

// round_ref(x, nd) for nd in {0, 2}: the nearest decimal of nd digits to
// the exact binary value, ties away from zero, returned as the nearest
// double.  False where Python's would raise (an infinite x); a NaN stays
// NaN.
bool round_ref(double x, int nd, double* out) {
    if (std::isnan(x)) { *out = x; return true; }
    if (std::isinf(x)) return false;
    const double pow10 = nd == 0 ? 1.0 : 100.0;
    // An exact tie at nd digits is x * 2**(nd+1) an odd integer.
    const double s = std::ldexp(x, nd + 1);
    if (std::fabs(s) < 9007199254740992.0 && s == std::trunc(s)
        && std::fmod(s, 2.0) != 0.0) {
        // x * 10**nd = q - 1/2 with q = (|s| * 5**nd + 1) / 2.
        const int64_t q =
            ((int64_t)std::fabs(s) * (nd == 0 ? 1 : 25) + 1) >> 1;
        double r;
        if (q < (int64_t)9007199254740992LL) {
            r = (double)q / pow10;
        } else {
            char buf[64];
            std::snprintf(buf, sizeof buf, "%llde-%d", (long long)q, nd);
            r = std::strtod(buf, nullptr);
        }
        *out = s < 0 ? -r : r;
        return true;
    }
    // Not a tie: the nearest decimal.  y = x * 10**nd is off the exact
    // product by at most half an ulp of y, so rint decides where y lies
    // further than that from a half; elsewhere the exact decimal route.
    const double y = x * pow10;
    if (std::fabs(y) < 4503599627370496.0) {
        const double f = y - std::floor(y);
        if (std::fabs(f - 0.5) > std::fabs(y) * 4.5e-16) {
            *out = std::nearbyint(y) / pow10;
            return true;
        }
    }
    char buf[400];
    std::snprintf(buf, sizeof buf, "%.*f", nd, x);
    *out = std::strtod(buf, nullptr);
    return true;
}

// ---------------------------------------------------------------------------
// Text
// ---------------------------------------------------------------------------

inline void put_uint(std::string& s, uint64_t v) {
    char buf[24];
    int n = 0;
    do {
        buf[n++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (n) s += buf[--n];
}

inline void put_int(std::string& s, int64_t v) {
    if (v < 0) {
        s += '-';
        put_uint(s, (uint64_t)0 - (uint64_t)v);
    } else {
        put_uint(s, (uint64_t)v);
    }
}

// writer._py2_float_str: "%.12g", then ".0" where the text has no '.',
// 'e' or 'n'; Python writes a NaN of either sign as "nan".
inline void put_float(std::string& s, double v) {
    if (std::isnan(v)) { s += "nan"; return; }
    char buf[40];
    const int n = std::snprintf(buf, sizeof buf, "%.12g", v);
    s.append(buf, n);
    if (!std::memchr(buf, '.', n) && !std::memchr(buf, 'e', n)
        && !std::memchr(buf, 'n', n))
        s += ".0";
}

// put_float of a round_ref(., 2) result v: the nearest double to k / 100,
// which "%.12g" writes as k / 100's decimal digits, trailing zeros dropped,
// wherever k has at most 12 digits.
inline void put_round2(std::string& s, double v) {
    if (!(std::fabs(v) < 1e9)) {
        put_float(s, v);
        return;
    }
    const uint64_t k = (uint64_t)std::nearbyint(std::fabs(v) * 100.0);
    if (std::signbit(v)) s += '-';
    put_uint(s, k / 100);
    const uint64_t frac = k % 100;
    s += '.';
    s += (char)('0' + frac / 10);
    if (frac % 10) s += (char)('0' + frac % 10);
}

// "%.<prec>f" % v (a NaN reads "nan").
inline void put_fixed(std::string& s, double v, int prec) {
    if (std::isnan(v)) { s += "nan"; return; }
    char buf[400];
    const int n = std::snprintf(buf, sizeof buf, "%.*f", prec, v);
    s.append(buf, n);
}

// A value of an INFO field that the Python route holds as an int or as a
// float (QD and MQ are the int 0 where they are not computed).
struct Num {
    bool is_int;
    int64_t i;
    double d;
    double as_float() const { return is_int ? (double)i : d; }
};

inline void put_num(std::string& s, const Num& v, bool rounded2) {
    if (v.is_int) put_int(s, v.i);
    else if (rounded2) put_round2(s, v.d);
    else put_float(s, v.d);
}

// The reference over the window: ref_file.get_sequence(start, end) with its
// clamps (start to 0, end to the contig's length - 1), served from the
// slice the caller fetched.
struct RefSlice {
    const char* seq;
    int64_t start, len, clamp_end;
    bool ok = true;

    std::string get(int64_t s, int64_t e) {
        if (s < 0) s = 0;
        if (e > clamp_end) e = clamp_end;
        if (e <= s) return std::string();
        if (s < start || e > start + len) {
            ok = false;
            return std::string();
        }
        return std::string(seq + (s - start), (size_t)(e - s));
    }
};

// Haplotype.homopolymer_length_for_variant.
int64_t homopolymer_length(RefSlice& ref, int64_t pos) {
    const std::string left = ref.get(pos - 20, pos);
    const std::string right = ref.get(pos + 1, pos + 21);
    if (left.empty() || right.empty()) return 0;
    const char lc = left.back(), rc = right[0];
    int64_t lsize = 0, rsize = 0;
    for (auto it = left.rbegin(); it != left.rend() && *it == lc; ++it)
        ++lsize;
    for (auto it = right.begin(); it != right.end() && *it == rc; ++it)
        ++rsize;
    return lc == rc ? lsize + rsize : std::max(lsize, rsize);
}

// records.compute_sc_value: the share of the two commonest characters.
double sc_value(const std::string& seq) {
    int64_t count[256] = {0};
    for (unsigned char c : seq) ++count[c];
    int64_t top1 = 0, top2 = 0;
    for (int c = 0; c < 256; ++c) {
        if (count[c] > top1) { top2 = top1; top1 = count[c]; }
        else if (count[c] > top2) top2 = count[c];
    }
    return (double)(top1 + top2) / (double)seq.size();
}

// Python's list slice assignment seq[a:b] = added, on a string.
std::string splice(const std::string& ref, int64_t a, int64_t b,
                   const char* added, int64_t n_added) {
    const int64_t len = (int64_t)ref.size();
    a = std::min(a, len);
    b = std::max(a, std::min(b, len));
    std::string out(ref, 0, (size_t)a);
    out.append(added, (size_t)n_added);
    out.append(ref, (size_t)b, std::string::npos);
    return out;
}

inline char upper(char c) { return (c >= 'a' && c <= 'z') ? c - 32 : c; }

// records.trim_left_padding.
void trim_left_padding(int64_t& pos, std::string& ref,
                       std::vector<std::string>& alts) {
    if (alts.empty()) return;
    size_t min_len = ref.size();
    int64_t max_len_diff = 0;
    for (const auto& a : alts) {
        min_len = std::min(min_len, a.size());
        const int64_t diff = (int64_t)ref.size() - (int64_t)a.size();
        max_len_diff = std::max(max_len_diff, diff < 0 ? -diff : diff);
    }
    for (size_t it = 1; it < min_len; ++it) {
        const char first = upper(alts[0][0]);
        bool first_same = true;
        for (const auto& a : alts) first_same &= upper(a[0]) == first;
        if (!first_same || upper(ref[0]) != first) break;
        if (max_len_diff > 0) {
            int n_second = 0;
            char second = 0;
            bool second_same = true;
            for (const auto& a : alts) {
                if (a.size() <= 1) continue;
                const char c = upper(a[1]);
                if (n_second++ == 0) second = c;
                else second_same &= c == second;
            }
            if (!second_same || (n_second && ref[1] != second)) break;
        }
        ref.erase(0, 1);
        for (auto& a : alts) a.erase(0, 1);
        ++pos;
    }
}

// records.compute_haplotype_score: the per-haplotype log10 likelihood sums
// of the last individual with reads (none: every score 0), clustered by
// gaps over 20; the first cluster, and the second where the first gap is
// under 50.  numpy reduces the [H, n] product LOG10E * loglik[:, rows]
// along axis 1 with the haplotypes in its inner loop, so each sum is a
// left fold over the rows when H > 1 (tests/test_torch_vcf_window.py pins
// that order); one haplotype scores 1 whatever its sum.  -1 where there
// is no haplotype (the Python route raises) or a sum is NaN (Python's
// sort orders no NaN as the C++ one would).
int64_t haplotype_score(const double* loglik, int64_t H, int64_t n_rows,
                        const int32_t* sample_idx, const int64_t* n_reads,
                        int32_t n_ind) {
    if (H == 0) return -1;
    int32_t last = -1;
    for (int32_t i = 0; i < n_ind; ++i)
        if (n_reads[i] > 0) last = i;
    std::vector<double> vals(H, 0.0);
    if (last >= 0) {
        for (int64_t h = 0; h < H; ++h) {
            const double* row = loglik + h * n_rows;
            double sum = 0.0;
            for (int64_t r = 0; r < n_rows; ++r)
                if (sample_idx[r] == last) sum += kLog10E * row[r];
            if (std::isnan(sum)) return -1;
            vals[h] = -sum;
        }
    }
    std::sort(vals.begin(), vals.end());
    int64_t first = 1, second = 0;
    int n_clusters = 1;
    double dist = 0.0;
    for (int64_t i = 1; i < H; ++i) {
        if (vals[i] - vals[i - 1] > 20) {
            if (n_clusters == 1) dist = vals[i] - vals[i - 1];
            if (n_clusters == 2) break;
            ++n_clusters;
            second = 1;
        } else if (n_clusters == 1) {
            ++first;
        } else {
            ++second;
        }
    }
    return 0 < dist && dist < 50 ? first + second : first;
}

// The fields of one called variant (compute_vcf_info).
struct VarInfo {
    std::string fr, pp, sc, source;
    double qual;        // float(PP)
    int64_t hp, tr, nf, nr, tc, tcr, tcf, mmlq;
    double ab_pval, sb_pval, brf;
    Num qd, mq;
    bool qd_cap;  // QD is config.qd_threshold + 10, written as given
};

enum Dim {
    kL, kRows, kInd, kG, kH, kGofStride, kV, kNU, kWindowCols, kRefStart,
    kRefLen, kRefClampEnd, kWS, kWE, kCols, kExact,
    kBadReadsWindow, kChromLen, kQdCapLen
};

enum Conf {
    cMinPosterior, cMinReads, cOutputRefCalls, cQd, cSc, cHapScore, cAb,
    cSb, cRmsmq, cBadReads, cFilteredReadsFrac, cQdCap
};

const int kVarCols = 8;  // var_i: see ptpu_vcf_window

}  // namespace

extern "C" {

// One called window's VCF data lines.
//
// Reads: the 14 arrays of ptpu_info_accumulate_window, [n_rows, L].
// Genotypes: lik [I, G] f64, freqs [H], h1 / h2 [G] int64, gof [G,
// gof_stride], n_reads [I] int64, gt_calls [I] int64 (-1 for none).
// Variants, in the order of output (by position, then as vars_by_pos
// lists them): var_i [V, 8] int64 = (bam_min_pos, bam_max_pos, ref_pos,
// n_removed, n_added, max_ref_pos, var_source, column in the universe),
// var_f [V, 2] = (prior, posterior), their added bases back to back.
// The universe: the window's variants (its first dims[kWindowCols]
// columns) and the called ones not among them; u_span [NU, 2] their
// (min_ref_pos, max_ref_pos), member [H, NU] 0 / 1: haplotype h carries it.
// loglik [H, n_rows]: the window's per-(haplotype, read) ln-likelihoods;
// ref: get_sequence(chrom, dims[kRefStart], ...) of dims[kRefLen] bytes;
// cols [n_cols]: the sample of each output column; conf and dims: see the
// enums above; qd_cap: the text of QD where PP > 2500.
// Output: the lines back to back in text (capacity cap); result [4 + 2 V]
// = (status: 0 written, 1 left to the Python route, 2 text too small;
// lines; bytes, or bytes needed; (variant, individual) + (position,
// sample) rows covered), then (1-based position, end offset) per line.
void ptpu_vcf_window(
    const uint8_t* seq, const uint8_t* qual, const int64_t* pos,
    const int64_t* end, const int32_t* rlen, const int32_t* mapq,
    const uint8_t* strand_reverse, const uint8_t* single_m,
    const int32_t* nsm_idx, const uint32_t* nsm_flat, const int64_t* nsm_off,
    const int32_t* sample_idx, const uint8_t* is_good,
    const uint8_t* is_broken,
    const double* lik, const double* freqs, const int64_t* h1,
    const int64_t* h2, const double* gof, const int64_t* n_reads,
    const int64_t* gt_calls,
    const int64_t* var_i, const double* var_f, const char* added_flat,
    const int64_t* u_span, const uint8_t* member,
    const double* loglik, const char* ref_seq, const char* chrom,
    const int64_t* cols,
    const int64_t* dims, const double* conf, const char* qd_cap,
    char* text, int64_t cap, int64_t* result) {
    int64_t* lines = result + 4;
    result[0] = 1;
    result[1] = result[2] = result[3] = 0;
    const int32_t L = (int32_t)dims[kL];
    const int64_t n_rows = dims[kRows];
    const int32_t I = (int32_t)dims[kInd];
    const int64_t G = dims[kG], H = dims[kH], gof_stride = dims[kGofStride];
    const int32_t V = (int32_t)dims[kV];
    const int64_t NU = dims[kNU], n_window_cols = dims[kWindowCols];
    RefSlice ref{ref_seq, dims[kRefStart], dims[kRefLen], dims[kRefClampEnd]};
    const int64_t hap_score =
        haplotype_score(loglik, H, n_rows, sample_idx, n_reads, I);
    if (hap_score < 0) return;

    // Non-ASCII bases: the Python route decodes them as UTF-8.
    for (int64_t k = 0; k < dims[kRefLen]; ++k)
        if ((unsigned char)ref_seq[k] >= 0x80) return;
    std::vector<int64_t> added_off(V + 1, 0);
    for (int32_t v = 0; v < V; ++v)
        added_off[v + 1] = added_off[v] + var_i[v * kVarCols + 4];
    for (int64_t k = 0; k < added_off[V]; ++k)
        if ((unsigned char)added_flat[k] >= 0x80) return;

    // INFO accounting: every (variant, individual) pass.
    std::vector<int64_t> spec(5 * (size_t)V);
    std::vector<uint8_t> var_in_gt((size_t)V * I, 0);
    for (int32_t v = 0; v < V; ++v) {
        const int64_t* vi = var_i + v * kVarCols;
        for (int k = 0; k < 5; ++k) spec[5 * v + k] = vi[k];
        const int64_t col = vi[7];
        for (int32_t i = 0; i < I; ++i) {
            const int64_t g = gt_calls[i];
            if (g < 0) continue;
            var_in_gt[(size_t)v * I + i] =
                member[h1[g] * NU + col] || member[h2[g] * NU + col];
        }
    }
    const ptpu::InfoReads w{seq, qual, L, pos, end, rlen, mapq,
                            strand_reverse, single_m, nsm_idx, nsm_flat,
                            nsm_off};
    std::vector<int64_t> counters((size_t)V * I * 14);
    std::vector<double> rms((size_t)V * I);
    std::vector<int32_t> min_quals(std::max<int64_t>(1, V * n_rows));
    int64_t n_good_bad[2];
    ptpu::info_accumulate_window(
        w, sample_idx, is_good, is_broken, n_rows, I, V, spec.data(),
        added_flat, var_in_gt.data(), (int32_t)dims[kExact],
        (int32_t)dims[kBadReadsWindow], counters.data(), rms.data(),
        min_quals.data(), n_good_bad);
    int64_t rows_covered = (int64_t)V * I;

    // compute_vcf_info, variant by variant.
    double brf;
    if (!round_ref((double)n_good_bad[1]
                       / (double)std::max<int64_t>(1, n_good_bad[0]
                                                          + n_good_bad[1]),
                   2, &brf))
        return;
    std::vector<VarInfo> info(V);
    int64_t minq_at = 0;
    for (int32_t v = 0; v < V; ++v) {
        const int64_t* vi = var_i + v * kVarCols;
        VarInfo& f = info[v];
        // FR: the frequencies of the haplotypes carrying it, in order.
        const int64_t col = vi[7];
        bool on_hap = false;
        double fr = 0.0;
        for (int64_t h = 0; h < H; ++h) {
            if (!member[h * NU + col]) continue;
            fr = on_hap ? fr + freqs[h] : freqs[h];
            on_hap = true;
        }
        const double posterior = var_f[2 * v + 1];
        if (!on_hap || !std::isfinite(posterior)) return;
        put_fixed(f.fr, fr, 4);
        put_fixed(f.pp, posterior, 0);
        f.qual = std::strtod(f.pp.c_str(), nullptr);
        f.hp = homopolymer_length(ref, vi[2]);
        f.sc = ref.get(vi[2] - 10, vi[2] + 11);

        int64_t t[13] = {0};
        double rmsmq = 0.0;
        int64_t n_minq = 0;
        for (int32_t i = 0; i < I; ++i) {
            const int64_t* c = &counters[((size_t)v * I + i) * 14];
            for (int k = 0; k < 13; ++k) t[k] += c[k];
            rmsmq += rms[(size_t)v * I + i];
            n_minq += c[13];
        }
        const int64_t tc = t[0], tc_bad = t[1], tr = t[2], tc_ab = t[3],
                      tr_ab = t[4], nf = t[5], nr = t[6], nf_sb = t[7],
                      nr_sb = t[8], tcf = t[9], tcr = t[10], tcf_sb = t[11],
                      tcr_sb = t[12];
        if (!round_ref(allele_bias_pvalue(tc_ab, tr_ab), 2, &f.ab_pval)
            || !round_ref(strand_bias_pvalue(tcf_sb, tcr_sb, nf_sb, nr_sb), 2,
                          &f.sb_pval))
            return;
        f.qd_cap = false;
        f.tr = tr; f.nf = nf; f.nr = nr;
        f.tc = tc; f.tcr = tcr; f.tcf = tcf;
        if (tr > 0) {
            if (f.qual > 2500) {
                f.qd = {false, 0, conf[cQdCap]};
                f.qd_cap = true;
            } else {
                const double prior = var_f[2 * v];
                if (!(prior > 0)) return;  // math.log10 raises
                f.qd = {false, 0,
                        (f.qual + (-10.0 * c_log10(prior))) / (double)tr};
            }
        } else {
            f.qd = {true, 0, 0.0};
        }
        f.brf = brf;
        if (tc + tc_bad > 0 && rmsmq > 0) {
            double mq;
            if (!round_ref(std::sqrt(rmsmq / (double)(tc + tc_bad)), 2, &mq))
                return;
            f.mq = {false, 0, mq};
        } else {
            f.mq = {true, 0, 0.0};
        }
        int32_t* mq_lo = min_quals.data() + minq_at;
        if (n_minq) {
            std::nth_element(mq_lo, mq_lo + n_minq / 2, mq_lo + n_minq);
            f.mmlq = mq_lo[n_minq / 2];
        } else {
            f.mmlq = 100;
        }
        minq_at += n_minq;
        const int64_t src = vi[6];
        if (src & 1) f.source = "Platypus";
        if (src & 4) f.source += f.source.empty() ? "Assembler" : ",Assembler";
        if (src & 2) f.source += f.source.empty() ? "File" : ",File";
    }
    if (!ref.ok) return;

    // The lines, position by position (output_call_to_vcf).
    const double min_posterior = conf[cMinPosterior];
    thread_local std::string s;
    thread_local std::vector<std::string> sample_txt;
    s.clear();
    sample_txt.resize(I);
    std::vector<int64_t> hap_is_ref(H);
    std::vector<uint8_t> var_in_hap;
    std::vector<double> marg;
    int64_t n_lines = 0;
    for (int32_t k0 = 0; k0 < V;) {
        const int64_t p = var_i[k0 * kVarCols + 2];
        int32_t k1 = k0 + 1;
        while (k1 < V && var_i[k1 * kVarCols + 2] == p) ++k1;
        const int32_t nv = k1 - k0;
        const VarInfo& first = info[k0];

        // compute_vcf_filter: each filter only where every allele fails.
        if (first.sc.empty()) return;  // compute_sc_value divides by 0
        const bool fails_sc = sc_value(first.sc) > conf[cSc];
        int n_qd = 0, n_hapscore = 0, n_sb = 0, n_ab = 0, n_rmsmq = 0,
            n_mmlq = 0;
        int64_t best_qual = 0, qual_col = 0;
        double brf_last = 0.0;
        for (int32_t k = k0; k < k1; ++k) {
            const VarInfo& f = info[k];
            if (!(std::fabs(f.qual) < 9e18)) return;
            const int64_t this_qual = (int64_t)f.qual;
            best_qual = std::max(best_qual, this_qual);
            qual_col = k == k0 ? this_qual : std::max(qual_col, this_qual);
            brf_last = f.brf;
            if ((double)f.mmlq < conf[cBadReads]) ++n_mmlq;
            if (f.qd.as_float() < conf[cQd]) ++n_qd;
            if ((double)hap_score > conf[cHapScore]) ++n_hapscore;
            if (f.tc > 0 && f.ab_pval < conf[cAb]) ++n_ab;
            if (f.sb_pval < conf[cSb]) ++n_sb;
            if (f.mq.as_float() < conf[cRmsmq]) ++n_rmsmq;
        }
        // In the writer's sorted order.
        const char* filters[8];
        int n_filters = 0;
        if (n_hapscore == nv) filters[n_filters++] = "HapScore";
        if (n_rmsmq == nv) filters[n_filters++] = "MQ";
        if (best_qual < 20) filters[n_filters++] = "Q20";
        if (n_qd == nv) filters[n_filters++] = "QD";
        if (fails_sc) filters[n_filters++] = "SC";
        if (n_ab == nv) filters[n_filters++] = "alleleBias";
        if (n_mmlq == nv || brf_last >= conf[cFilteredReadsFrac])
            filters[n_filters++] = "badReads";
        if (n_sb == nv) filters[n_filters++] = "strandBias";

        // Haplotypes reference at p, and which carry each allele.
        var_in_hap.assign((size_t)H * nv, 0);
        for (int64_t h = 0; h < H; ++h) {
            const uint8_t* m = member + h * NU;
            int64_t is_ref = 1;
            for (int64_t j = 0; j < n_window_cols && is_ref; ++j)
                if (m[j] && u_span[2 * j] <= p && p <= u_span[2 * j + 1])
                    is_ref = 0;
            for (int32_t k = k0; k < k1; ++k) {
                const int64_t j = var_i[k * kVarCols + 7];
                if (!m[j]) continue;
                var_in_hap[h * nv + (k - k0)] = 1;
                if (u_span[2 * j] <= p && p <= u_span[2 * j + 1]) is_ref = 0;
            }
            hap_is_ref[h] = is_ref;
        }

        // ref_and_alt.
        bool non_snp = false, indel = false;
        int64_t rl = 0;
        for (int32_t k = k0; k < k1; ++k) {
            const int64_t n_rem = var_i[k * kVarCols + 3];
            const int64_t n_add = var_i[k * kVarCols + 4];
            non_snp |= n_rem != 1 || n_add != 1;
            indel |= n_rem != n_add;
            rl = std::max(rl, n_rem);
        }
        std::string ref_allele;
        std::vector<std::string> alts;
        alts.reserve(nv);
        if (!non_snp) {
            ref_allele = ref.get(p, p + 1);
            for (int32_t k = k0; k < k1; ++k)
                alts.emplace_back(added_flat + added_off[k],
                                  (size_t)(added_off[k + 1] - added_off[k]));
        } else {
            ref_allele = ref.get(p, p + rl + (indel ? 1 : 0));
            for (int32_t k = k0; k < k1; ++k) {
                const int64_t n_rem = var_i[k * kVarCols + 3];
                const int64_t n_add = var_i[k * kVarCols + 4];
                const char* a = added_flat + added_off[k];
                // seq[0:n_added] = added for a substitution, else
                // seq[1:1 + n_removed] = added.
                alts.push_back(n_rem == n_add
                                   ? splice(ref_allele, 0, n_add, a, n_add)
                                   : splice(ref_allele, 1, 1 + n_rem, a,
                                            n_add));
            }
        }
        if (!ref.ok) return;

        // Every sample's fields (the native genotype call of each sample
        // with reads), in buffer order.
        const int64_t n_classes = (int64_t)(nv + 1) * (nv + 2) / 2;
        marg.resize(n_classes);
        double max_gof = 0.0;
        int64_t n_non_ref = 0;
        for (int32_t i = 0; i < I; ++i) {
            std::string& t = sample_txt[i];
            t.clear();
            if (n_reads[i] == 0) {
                t = "./.:0,0,0:0:0:0:0";
                continue;
            }
            int32_t phased[2];
            double sc[5];
            ptpu::genotype_call_one(lik + (int64_t)i * G, freqs, h1, h2, G,
                                    hap_is_ref.data(), var_in_hap.data(), nv,
                                    gof, gof_stride, i, I, marg.data(),
                                    phased, sc);
            ++rows_covered;
            const double sum_lik = sc[3] == 0 ? 1.0 : sc[3];
            const double post[3] = {sc[0] / sum_lik, sc[1] / sum_lik,
                                    sc[2] / sum_lik};
            const double gof_value = sc[4];
            if (!(phased[0] == 0 && phased[1] == 0)) ++n_non_ref;
            // phred = int(min(99, round_ref(-10 log10(max(1e-10, 1 - x)))))
            int64_t phred[3];
            for (int k = 0; k < 3; ++k) {
                double r;
                if (!round_ref(-10.0 * c_log10(py_max(1e-10, 1.0 - post[k])),
                               0, &r))
                    return;
                phred[k] = r < 99 ? (int64_t)r : 99;
            }
            const int64_t phred_post = phred[0], phred_non_ref = phred[1],
                          phred_ref = phred[2];
            const char* gt = nullptr;
            if (nv == 1 && phred_non_ref < min_posterior
                && phred_ref < min_posterior)
                gt = "./.";
            else if (nv == 1 && phred_non_ref < min_posterior)
                gt = "0/0";
            const int64_t reads_at_first = counters[((size_t)k0 * I + i) * 14];
            if (nv == 1 && (double)reads_at_first < conf[cMinReads])
                gt = "./.";
            if (!std::isfinite(gof_value) || std::fabs(gof_value) >= 9e18)
                return;
            if (gt) {
                t += gt;
            } else {
                put_int(t, phased[0]);
                t += '/';
                put_int(t, phased[1]);
            }
            t += ':';
            if (nv == 1) {
                double max_like = marg[0];
                for (int64_t c = 1; c < n_classes; ++c)
                    if (marg[c] > max_like) max_like = marg[c];
                if (max_like == 0.0) return;  // ZeroDivisionError
                for (int64_t c = 0; c < n_classes; ++c) {
                    const double q = py_max(marg[c] / max_like, 1e-300);
                    if (q <= 0) return;  // math.log10 raises
                    double gl;
                    if (!round_ref(c_log10(q), 2, &gl)) return;
                    if (c) t += ',';
                    put_round2(t, gl);
                }
            } else {
                t += "-1,-1,-1";
            }
            t += ':';
            put_int(t, (int64_t)gof_value);
            t += ':';
            put_int(t, phred_post);
            t += ':';
            for (int32_t k = k0; k < k1; ++k) {
                if (k > k0) t += ',';
                put_int(t, counters[((size_t)k * I + i) * 14]);
            }
            t += ':';
            for (int32_t k = k0; k < k1; ++k) {
                if (k > k0) t += ',';
                put_int(t, counters[((size_t)k * I + i) * 14 + 2]);
            }
            if (gof_value > max_gof) max_gof = gof_value;
        }
        double mgof;
        if (!round_ref(max_gof, 2, &mgof)) return;

        k0 = k1;
        if (!(n_non_ref > 0 || min_posterior == 0
              || conf[cOutputRefCalls] == 1))
            continue;
        int64_t out_pos = p;
        trim_left_padding(out_pos, ref_allele, alts);
        bool canonical = true;
        for (char c : ref_allele)
            canonical &= c == 'A' || c == 'C' || c == 'G' || c == 'T';
        if (!canonical) continue;

        // The record, as VCFWriter.write_record writes it.
        s.append(chrom, (size_t)dims[kChromLen]);
        s += '\t';
        put_int(s, out_pos + 1);
        s += "\t.\t";
        s += ref_allele;
        s += '\t';
        for (size_t a = 0; a < alts.size(); ++a) {
            if (a) s += ',';
            s += alts[a];
        }
        s += '\t';
        put_int(s, qual_col);
        s += '\t';
        if (!n_filters) s += "PASS";
        for (int k = 0; k < n_filters; ++k) {
            if (k) s += ';';
            s += filters[k];
        }
        // INFO, keys sorted.
        s += "\tBRF=";
        put_round2(s, first.brf);
        s += ";FR=";
        for (int32_t k = k0 - nv; k < k0; ++k) {
            if (k > k0 - nv) s += ',';
            s += info[k].fr;
        }
        s += ";HP=";
        put_int(s, first.hp);
        s += ";HapScore=";
        put_int(s, hap_score);
        s += ";MGOF=";
        put_int(s, (int64_t)mgof);
        s += ";MMLQ=";
        put_int(s, first.mmlq);
        s += ";MQ=";
        put_num(s, first.mq, true);
        s += ";NF=";
        for (int32_t k = k0 - nv; k < k0; ++k) {
            if (k > k0 - nv) s += ',';
            put_int(s, info[k].nf);
        }
        s += ";NR=";
        for (int32_t k = k0 - nv; k < k0; ++k) {
            if (k > k0 - nv) s += ',';
            put_int(s, info[k].nr);
        }
        s += ";PP=";
        for (int32_t k = k0 - nv; k < k0; ++k) {
            if (k > k0 - nv) s += ',';
            s += info[k].pp;
        }
        s += ";QD=";
        if (first.qd_cap) s.append(qd_cap, (size_t)dims[kQdCapLen]);
        else put_num(s, first.qd, false);
        s += ";SC=";
        s += first.sc;
        s += ";SbPval=";
        put_round2(s, first.sb_pval);
        s += ";Source=";
        s += first.source;
        s += ";TC=";
        put_int(s, first.tc);
        s += ";TCF=";
        put_int(s, first.tcf);
        s += ";TCR=";
        put_int(s, first.tcr);
        s += ";TR=";
        for (int32_t k = k0 - nv; k < k0; ++k) {
            if (k > k0 - nv) s += ',';
            put_int(s, info[k].tr);
        }
        s += ";WE=";
        put_int(s, dims[kWE]);
        s += ";WS=";
        put_int(s, dims[kWS]);
        s += "\tGT:GL:GOF:GQ:NR:NV";
        for (int64_t c = 0; c < dims[kCols]; ++c) {
            s += '\t';
            s += sample_txt[cols[c]];
        }
        s += '\n';
        lines[2 * n_lines] = out_pos + 1;
        lines[2 * n_lines + 1] = (int64_t)s.size();
        ++n_lines;
    }

    result[1] = n_lines;
    result[2] = (int64_t)s.size();
    result[3] = rows_covered;
    if ((int64_t)s.size() > cap) {
        result[0] = 2;
        return;
    }
    std::memcpy(text, s.data(), s.size());
    result[0] = 0;
}

}  // extern "C"
