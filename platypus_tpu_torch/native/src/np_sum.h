// numpy-order float64 summation helpers shared by the bit-exact host
// kernels (em.cpp, genotype.cpp).  numpy reduces a contiguous axis with
// pairwise summation: 8-way unrolled partials below 128 elements, then a
// halving recursion on 8-aligned splits.  Matching this order makes +,*
// -only kernels reproduce numpy to the last bit.
#pragma once

namespace ptpu {

inline double np_pairwise_sum(const double* a, long n) {
    if (n < 8) {
        double res = 0.0;
        for (long i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
        double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
        long i;
        for (i = 8; i + 8 <= n; i += 8) {
            r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
            r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
        }
        double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    long n2 = n / 2;
    n2 -= n2 % 8;
    return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

}  // namespace ptpu
