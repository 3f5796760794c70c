// The VCF output's native parts that more than one entry runs: the INFO
// accounting of a window (scan.cpp) and the genotype call of one sample at
// one position (genotype.cpp).  ptpu_info_accumulate_window,
// ptpu_genotype_call_samples and ptpu_vcf_window (vcf_window.cpp) call them.
#pragma once

#include <cstdint>

namespace ptpu {

// The window's read arrays, shared by every (variant, individual) pass.
struct InfoReads {
    const uint8_t* seq;
    const uint8_t* qual;
    int32_t L;
    const int64_t* pos;
    const int64_t* end;
    const int32_t* rlen;
    const int32_t* mapq;
    const uint8_t* strand_reverse;
    const uint8_t* single_m;
    const int32_t* nsm_idx;
    const uint32_t* nsm_flat;
    const int64_t* nsm_off;
};

// Every (variant, individual) INFO pass of a window; see
// ptpu_info_accumulate_window for the layout of the arguments.
void info_accumulate_window(
    const InfoReads& w, const int32_t* sample_idx, const uint8_t* is_good,
    const uint8_t* is_broken, int64_t n_rows, int32_t n_ind, int32_t n_var,
    const int64_t* var_spec, const char* added_flat,
    const uint8_t* var_in_genotype, int32_t exact, int32_t bad_reads_window,
    int64_t* counters, double* rmsmq, int32_t* min_quals,
    int64_t* n_good_bad);

// One sample's genotype call at one position; see genotype.cpp.
void genotype_call_one(
    const double* lik, const double* freqs,
    const int64_t* h1, const int64_t* h2, int64_t G,
    const int64_t* hap_is_ref,
    const uint8_t* var_in_hap, int64_t n_vars,
    const double* gof, int64_t gof_stride, int64_t gof_off,
    int32_t n_individuals,
    double* lik_out, int32_t* phased_out, double* scalars_out);

}  // namespace ptpu
