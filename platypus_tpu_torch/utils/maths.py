"""Special functions used by the calling model and filters.

These reproduce the numeric contracts of the reference implementation
(Platypus src/cython/platypusutils.pyx:178-337): Stirling-series
log-factorial, log-beta, a 3F2-based beta-binomial CDF (used for REFCALL
quality and the strand/allele bias filters) and an optimised binomial pmf.
All are host-side scalar math (they run per emitted variant, not per read),
so plain Python/NumPy is the right tool here.
"""

from __future__ import annotations

import math
from decimal import ROUND_HALF_UP, Decimal

_TWO_PI = 2.0 * math.pi

# round_ref fast-path tables: an exact decimal tie at `ndigits` requires the
# value to be odd/2**(ndigits+1) (any factor of 5 left in the denominator is
# not binary-representable), so ties are detected exactly by a power-of-two
# scale.  Indexed by ndigits.
_TIE_SCALE = (2.0, 4.0, 8.0, 16.0)
_POW10 = (1.0, 10.0, 100.0, 1000.0)
_POW5_INT = (1, 5, 25, 125)


def round_ref(x: float, ndigits: int = 0) -> float:
    """The reference's rounding semantics: CPython 2.7 round() and C
    round() both round to nearest with ties AWAY from zero, correctly
    rounded on the exact binary value.  Python 3's round() rounds ties to
    even, silently diverging on exactly-representable halves — e.g.
    BRF = 1/8 emits 0.12 under banker's rounding where the reference
    emits 0.13.

    Fast path: CPython's two-arg round() is correctly rounded (dtoa)
    half-even on the exact binary value, which equals HALF_UP everywhere
    except exact ties; a double is an exact tie at `ndigits` iff
    x * 2**(ndigits+1) is an odd integer, and that scale is exact in
    binary.  The Decimal quantize below is the semantic definition and
    the fallback (tests pin the two paths against each other)."""
    if 0 <= ndigits <= 3:
        s = x * _TIE_SCALE[ndigits]
        if -9e15 < s < 9e15:
            si = int(s)
            if si != s or not (si & 1):
                return round(x, ndigits)
            # Exact tie x = si/2**(n+1), i.e. x*10**n = si*5**n/2 is an odd
            # half-integer: round away from zero.  q = (|si|*5**n + 1)/2 is
            # the result scaled by 10**n; keep q below 2**53 so the float
            # conversion and division are both exact/correctly rounded.
            q = (-si if si < 0 else si) * _POW5_INT[ndigits] + 1 >> 1
            if q < 9007199254740992:
                r = q / _POW10[ndigits]
                return -r if si < 0 else r
    return _round_ref_decimal(x, ndigits)


def _round_ref_decimal(x: float, ndigits: int = 0) -> float:
    """Semantic definition of round_ref: HALF_UP quantize on the exact
    binary value (Decimal(float) is exact)."""
    q = Decimal(1).scaleb(-ndigits)
    return float(Decimal(x).quantize(q, rounding=ROUND_HALF_UP))

def log_factorial(x: int) -> float:
    """ln(x!) — exact below 15, Stirling series above (platypusutils.pyx:178)."""
    if x < 15:
        ans = 0.0
        for i in range(1, x + 1):
            ans += math.log(i)
        return ans
    y = float(x)
    return (
        y * math.log(y)
        + math.log(_TWO_PI * y) / 2.0
        - y
        + (y ** -1) / 12.0
        - (y ** -3) / 360.0
        + (y ** -5) / 1260.0
        - (y ** -7) / 1680.0
        + (y ** -9) / 1188.0
    )


def log_beta(x: int, y: int) -> float:
    """ln B(x, y) for positive integers (platypusutils.pyx:213)."""
    return log_factorial(x - 1) + log_factorial(y - 1) - log_factorial(x + y - 1)


def _three_f_two(k: int, n: int, alpha: int, beta: int) -> float:
    """Generalised hypergeometric 3F2 term sum (platypusutils.pyx:267-294)."""
    a_2 = alpha + k + 1.0
    a_3 = k - n + 1.0
    b_1 = k + 2.0
    b_2 = -beta - n + k + 2.0
    the_sum = 1.0
    last_term = 1.0
    for i in range(1, abs(k - n + 1) + 1):
        new_term = last_term * (a_2 + i - 1) * (a_3 + i - 1) / ((b_1 + i - 1) * (b_2 + i - 1))
        the_sum += new_term
        last_term = new_term
    return the_sum


def beta_binomial_cdf(k: int, n: int, alpha: int, beta: int) -> float:
    """P(X <= k) for X ~ BetaBinomial(n, alpha, beta) (platypusutils.pyx:306-315).

    Returns max(1e-30, value) exactly as the reference does; note the reference
    computes 1 - upper-tail via the 3F2 representation.
    """
    if k == n:
        return 1.0
    numerator = log_beta(beta + n - k - 1, alpha + k + 1) + math.log(_three_f_two(k, n, alpha, beta))
    denominator = log_beta(alpha, beta) + log_beta(n - k, k + 2) + math.log(n + 1)
    return max(1e-30, 1.0 - math.exp(numerator - denominator))


def binomial_pmf(x: int, size: int, prob: float) -> float:
    """Binomial pmf with the reference's degenerate-case handling
    (platypusutils.pyx:319-337)."""
    if x == size and prob == 1:
        return 1.0
    if x != size and prob == 1:
        return 0.0
    if x == 0 and prob == 0:
        return 1.0
    if x == 0 and prob == 1:
        return 0.0
    if x == 0 and size == 0:
        return 1.0
    log_coeff = log_factorial(size) - (log_factorial(x) + log_factorial(size - x))
    log_prob = x * math.log(prob) + (size - x) * math.log(1.0 - prob)
    return math.exp(log_coeff + log_prob)


def n_combinations_with_replacement(n_objects: int, n_chosen: int) -> int:
    """C(n + k - 1, k) via log-factorials (platypusutils.pyx:371-377)."""
    return int(
        round(
            math.exp(
                log_factorial(n_chosen + n_objects - 1)
                - (log_factorial(n_chosen) + log_factorial(n_objects - 1))
            ),
            2,
        )
    )


# ln(10)/10 with the sign folded in: phred -> natural log conversion factor.
MLTOT = -0.23025850929940459
LOG10E = 0.43429448190325182


def mann_whitney_rank_sum_z(group1, group2):
    """Mann-Whitney U rank-sum z-score (normal approximation, tie-corrected,
    continuity-corrected) between two samples of values.

    Used for the ReadPosRankSum INFO field: group1 = variant positions
    within alt-supporting reads, group2 = within ref reads.  The reference
    declares the field in its header (vcfutils.pyx:98) but never computes
    it; this completes the declared surface.  Positive z means the alt
    positions rank higher (further from read ends) than ref positions.

    Returns None when either group is empty (emitted as '.').
    """
    n1, n2 = len(group1), len(group2)
    if n1 == 0 or n2 == 0:
        return None
    values = list(group1) + list(group2)
    n = n1 + n2
    order = sorted(range(n), key=lambda i: values[i])
    ranks = [0.0] * n
    tie_term = 0.0
    i = 0
    while i < n:
        j = i
        while j + 1 < n and values[order[j + 1]] == values[order[i]]:
            j += 1
        avg_rank = 0.5 * (i + j) + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg_rank
        t = j - i + 1
        tie_term += t * t * t - t
        i = j + 1
    r1 = sum(ranks[:n1])
    u1 = r1 - n1 * (n1 + 1) / 2.0
    mu = n1 * n2 / 2.0
    var = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1))) if n > 1 else 0.0
    if var <= 0.0:
        return 0.0
    diff = u1 - mu
    # Continuity correction toward zero.
    if diff > 0.5:
        diff -= 0.5
    elif diff < -0.5:
        diff += 0.5
    else:
        return 0.0
    return diff / math.sqrt(var)
