"""Tumour/normal somatic head.

Reimplements Platypus extensions/Cancer/somaticMutationDetector.py:
for each biallelic call with genotyped tumour+normal samples, the somatic
posterior sums 10^(GL_normal + GL_tumour) over genotype-pair patterns where
the normal is 0/0 and the tumour carries the variant, against all pairs,
with prior 1e-6; the phred posterior is capped by the original call QUAL
and rewritten into the QUAL column.

The core scorer is a pure function over GL arrays, so it can be applied
either to VCF records (CLI-compatible post-processing) or directly to the
engine's per-sample genotype-likelihood tensors.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, TextIO

import numpy as np

SOMATIC_PRIOR = math.log10(1e-6)
NORMAL_PRIOR = math.log10(1.0 - 1e-6)


def somatic_posterior_phred(call_quality: float, normal_gls: Sequence[float],
                            tumour_gls: Sequence[float]) -> int:
    """Phred posterior that a variant is somatic, capped at call QUAL."""
    somatic = []
    all_likelihoods = []
    for n_idx in range(3):
        for t_idx in range(3):
            if n_idx == 0 and t_idx in (1, 2):
                v = SOMATIC_PRIOR + normal_gls[n_idx] + tumour_gls[t_idx]
                somatic.append(v)
                all_likelihoods.append(v)
            else:
                all_likelihoods.append(NORMAL_PRIOR + normal_gls[n_idx] + tumour_gls[t_idx])
    max_like = max(all_likelihoods + somatic)
    sum_all = sum(10 ** (x - max_like) for x in all_likelihoods)
    sum_somatic = sum(10 ** (x - max_like) for x in somatic)
    posterior = sum_somatic / sum_all
    phred = max(0, int(-10 * math.log10(max(1e-10, 1.0 - posterior)) + 0.5))
    return min(int(call_quality), phred)


def somatic_posteriors_batch(call_quality: np.ndarray, normal_gls: np.ndarray,
                             tumour_gls: np.ndarray) -> np.ndarray:
    """Vectorised version over [N, 3] GL arrays."""
    out = np.zeros(len(call_quality), dtype=np.int64)
    for i in range(len(call_quality)):
        out[i] = somatic_posterior_phred(call_quality[i], normal_gls[i], tumour_gls[i])
    return out


def filter_somatic_vcf(in_vcf: TextIO, out_vcf: TextIO, tumour_sample: str,
                       normal_sample: str, min_posterior: int = 5) -> int:
    """Stream a joint-called 2-sample VCF, keep somatic calls, rewrite QUAL."""
    normal_col: Optional[int] = None
    tumour_col: Optional[int] = None
    n_out = 0
    for line in in_vcf:
        if line.startswith("##"):
            out_vcf.write(line)
            continue
        if line.startswith("#CHROM"):
            out_vcf.write(line)
            cols = line.strip().split("\t")
            normal_col = cols.index(normal_sample)
            tumour_col = cols.index(tumour_sample)
            continue
        cols = line.strip().split("\t")
        if "," in cols[4]:
            continue
        tumour = cols[tumour_col].split(":")
        normal = cols[normal_col].split(":")
        if "." in tumour[0] or "." in normal[0]:
            continue
        call_quality = int(float(cols[5]))
        tumour_gls = [float(x) for x in tumour[1].split(",")]
        normal_gls = [float(x) for x in normal[1].split(",")]
        post = somatic_posterior_phred(call_quality, normal_gls, tumour_gls)
        if post >= min_posterior:
            cols[5] = str(post)
            out_vcf.write("\t".join(cols) + "\n")
            n_out += 1
    return n_out
