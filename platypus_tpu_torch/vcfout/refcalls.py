"""REFCALL block output (reference variantcaller.pyx:764-867).

Quality logic: zero coverage -> 0; coverage but no candidates -> phred of a
beta-binomial(20,20) tail on the minimum per-base coverage; candidates that
failed to reach the posterior threshold cap the quality via their best
flat-prior posterior.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..candidates.windows import Window
from ..config import PlatypusConfig
from ..ops import likelihood as lk
from ..utils.maths import beta_binomial_cdf, round_ref
from .writer import VCFWriter


def _min_coverage(buffers, window: Window) -> int:
    positions = np.arange(window.start_pos, window.end_pos, dtype=np.int64)
    min_cov = -1
    for buf in buffers:
        counts = buf.count_reads_covering_positions(positions)
        cov = int(counts.min()) if len(counts) else 0
        min_cov = cov if min_cov == -1 else min(min_cov, cov)
    return max(0, min_cov)


def output_ref_call(
    window: Window,
    buffers,
    ref_file,
    config: PlatypusConfig,
    writer: VCFWriter,
    call=None,
    last_window_nr=None,
) -> None:
    min_cov = _min_coverage(buffers, window)
    phred_pvalue = int(-10 * math.log10(beta_binomial_cdf(0, min_cov, 20, 20)))

    if min_cov == 0:
        qual = 0
    elif not window.variants:
        qual = phred_pvalue
    else:
        max_post = 0.0
        if call is not None:
            for v in window.variants:
                has_var = np.array([v in s for s in call.hap_var_sets])
                post = lk.variant_posterior_phred(
                    call.likelihoods, call.frequencies, has_var,
                    call.hap1_idx, call.hap2_idx, call.n_reads, prior=0.5,
                )
                max_post = max(max_post, post)
        max_prob_var = 1.0 - 10 ** (-0.1 * max_post)
        prob_ref = 1.0 - max_prob_var
        qual = min(int(round_ref(-10.0 * math.log10(max(1e-10, 1.0 - prob_ref)))), phred_pvalue)

    ref = ref_file.get_sequence(window.chromosome, window.start_pos, window.start_pos + 1).decode()
    alt = ["T"] if ref == "N" else ["N"]

    info = {
        "END": [window.end_pos],
        "Size": [window.end_pos - window.start_pos],
    }
    for key in ("FR", "MMLQ", "HP", "TCR", "WE", "WS", "Source", "FS", "START", "PP",
                "TR", "NF", "TCF", "NR", "TC", "MGOF", "SbPval", "ReadPosRankSum",
                "MQ", "QD", "SC", "BRF", "HapScore"):
        info[key] = ["."]

    # NR on REFCALL lines replicates the reference's stale-pointer
    # behaviour (variantcaller.pyx:856-866): it reports the read count of
    # the buffer's most recently SET variant window (0 before any), NOT
    # the refcall block's own coverage — the window pointers are only
    # moved when a variant window is processed.  Verified against the
    # RUNNING reference (docs/REFERENCE_RUN.md).
    sample_data = {}
    for i, buf in enumerate(buffers):
        n = last_window_nr[i] if last_window_nr is not None else 0
        sample_data[buf.sample] = dict(
            GT=[[".", "/", "."]], GL=[-1, -1, -1], GQ=[-1], GOF=[-1],
            NR=[n], NV=[0],
        )

    writer.write_record(
        window.chromosome, window.start_pos, ref, alt, qual, ["REFCALL"],
        info, ["GT", "GL", "GOF", "GQ", "NR", "NV"], sample_data,
    )
