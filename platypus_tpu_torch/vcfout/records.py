"""Variant record assembly: INFO/FILTER computation and per-sample genotype
output for called windows.

Faithful reimplementation of Platypus src/cython/vcfutils.pyx:

* per-variant read counting (TC/TR/NF/NR/MQ/BRF/MMLQ and the bias inputs)
  re-walks the window's good and bad reads against the variant's BAM span
  (vcfutils.pyx:1278-1459, readOverlapsVariant/variantSupportedByRead);
* HapScore clusters per-haplotype likelihood sums (vcfutils.pyx:1076-1114);
* strand/allele-bias use the beta-binomial CDF (vcfutils.pyx:1156-1222);
* the FILTER field applies the all-alleles-must-fail rule per position
  (vcfutils.pyx:1502-1627);
* per-sample genotype calls marginalise genotype likelihoods over
  allele-pair patterns with ML phasing (vcfutils.pyx:163-334) and the
  posterior/NR-based ./., 0/0 overrides (vcfutils.pyx:491-548);
* REF/ALT construction pads indel anchors (refAndAlt, vcfutils.pyx:843-897)
  and trims redundant left padding (trimLeftPadding, vcfutils.pyx:796-839).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..candidates.variant import ASSEMBLER_VAR, FILE_VAR, PLATYPUS_VAR, Variant
from ..config import PlatypusConfig
from ..engine.caller import WindowCall
from ..io.bam import CIGAR_D, CIGAR_EQ, CIGAR_I, CIGAR_M, CIGAR_N, CIGAR_S, CIGAR_X
from ..utils.maths import beta_binomial_cdf, round_ref
from .. import native
from .writer import FILTER_NAMES, VCFWriter

LOG10E = 0.43429448190325182
CANONICAL = set(b"ACGT")


# ---------------------------------------------------------------------------
# Read-level support checks
# ---------------------------------------------------------------------------

def _read_qual_good(qual: np.ndarray, rlen: int, pos: int,
                    var_min: int, var_max: int) -> bool:
    lo = max(0, min(rlen, var_min - pos))
    hi = max(0, min(rlen, var_max - pos))
    if hi <= lo:
        return True
    return bool((qual[lo:hi] >= 5).all())


def variant_supported_by_read(cigar: np.ndarray, seq: np.ndarray, rlen: int,
                              read_start: int, variant: Variant,
                              exact_indels: bool) -> bool:
    """vcfutils.pyx:961-1072."""
    ref_off = 0
    read_off = 0
    var_pos = variant.ref_pos
    added = variant.added
    n_add = variant.n_added
    n_rem = variant.n_removed
    for ci in range(len(cigar)):
        op = int(cigar[ci, 0])
        length = int(cigar[ci, 1])
        if op == CIGAR_I:
            if n_add != n_rem:
                if exact_indels:
                    if n_add - n_rem == length:
                        start = read_off
                        if bytes(seq[start : start + n_add]) == added:
                            return True
                    return False
                return True
            read_off += length
        elif op == CIGAR_D:
            if n_add != n_rem:
                if exact_indels:
                    return n_rem - n_add == length
                return True
            ref_off += length
        elif op in (CIGAR_M, CIGAR_EQ, CIGAR_X):
            start = var_pos - read_start + read_off - ref_off
            if (
                ref_off + read_start <= var_pos
                and ref_off + read_start + length > var_pos
                and n_add == n_rem
            ):
                if start + n_add <= rlen and start >= 0:
                    if bytes(seq[start : start + n_add]) == added:
                        return True
            read_off += length
            ref_off += length
        elif op == CIGAR_N:
            read_off += length
            ref_off += length
        elif op == CIGAR_S:
            read_off += length
            if ci == 0:
                ref_off += length
    return False


# ---------------------------------------------------------------------------
# Haplotype-level INFO
# ---------------------------------------------------------------------------

def compute_haplotype_score(call: WindowCall) -> int:
    """Likelihood clustering of haplotypes (vcfutils.pyx:1076-1114).

    The reference uses the per-hap log10-likelihood sums of the *last*
    individual whose data was computed.
    """
    last = -1
    for i in range(len(call.n_reads)):
        if call.n_reads[i] > 0:
            last = i
    H = len(call.haplotypes)
    if last == -1:
        scores = {h: 0.0 for h in range(H)}
    else:
        # NOTE: this exact expression (fancy-index copy, then multiply,
        # then pairwise sum) is part of the byte contract: numpy's SIMD
        # pairwise sum is alignment-sensitive in the last ulp, and real
        # windows sit exactly on the dist==50 cluster boundary below — a
        # "faster" view-based slice changed emitted HapScore values.
        rows = np.nonzero(call.reads.sample_idx == last)[0]
        sums = (LOG10E * call.loglik[:, rows]).sum(axis=1)
        scores = {h: -float(sums[h]) for h in range(H)}
    # Dict keyed by haplotype: identical-sequence haps collapsed already.
    vals = sorted(scores.values())
    clusters = [[vals[0]]]
    dist = 0.0
    for i in range(1, len(vals)):
        if vals[i] - vals[i - 1] > 20:
            if len(clusters) == 1:
                dist = vals[i] - vals[i - 1]
            if len(clusters) == 2:
                break
            clusters.append([vals[i]])
        else:
            clusters[-1].append(vals[i])
    score = len(clusters[0])
    if 0 < dist < 50:
        score += len(clusters[1])
    return score


def allele_bias_pvalue(total_reads: int, variant_reads: int) -> float:
    if total_reads > 0 and variant_reads / total_reads >= 0.5:
        return 1.0
    if total_reads == 0:
        return 1.0
    p = beta_binomial_cdf(variant_reads, total_reads, 20, 20)
    return min(p, 1.0 - p)


def strand_bias_pvalue(n_fwd: int, n_rev: int, n_fwd_var: int, n_rev_var: int) -> float:
    if n_fwd == 0 or n_rev == 0:
        return 1.0
    use_forward = n_fwd >= n_rev
    if n_fwd + n_rev > 0 and n_fwd_var + n_rev_var > 0:
        freq = (n_fwd if use_forward else n_rev) / (n_fwd + n_rev)
        if freq < 0.5:
            alpha = 20
            beta = int(alpha / freq - alpha)
        elif freq > 0.5:
            beta = 20
            alpha = int(beta * freq / (1.0 - freq))
        else:
            alpha = beta = 20
        k = n_fwd_var if use_forward else n_rev_var
        return beta_binomial_cdf(k, n_fwd_var + n_rev_var, alpha, beta)
    return 1.0


def compute_sc_value(sequence: str) -> float:
    """Fraction of the context made of its 2 most common bases
    (vcfutils.pyx:1480-1498)."""
    counter: Dict[str, int] = {}
    for ch in sequence:
        counter[ch] = counter.get(ch, 0) + 1
    top2 = sum(x[0] for x in sorted(((n, b) for b, n in counter.items()), reverse=True)[:2])
    return top2 / len(sequence)


# ---------------------------------------------------------------------------
# vcfINFO / vcfFILTER
# ---------------------------------------------------------------------------

def _window_nsm_csr(reads):
    """CSR of the window's non-single-M CIGARs for the native INFO pass:
    (row -> csr index or -1, flat words, offsets)."""
    sm = reads.single_m()
    R = len(sm)
    nsm_idx = np.full(R, -1, np.int32)
    rows = np.nonzero(~sm)[0]
    if len(rows) == 0:
        return nsm_idx, np.zeros(1, np.uint32), np.zeros(1, np.int64)
    refs = reads.cigar_refs
    flats = []
    lens = np.zeros(len(rows), np.int64)
    offs = getattr(refs, "offsets", None)
    if offs is not None:
        segs = np.searchsorted(offs, rows, side="right") - 1
        for j, (wr, seg) in enumerate(zip(rows.tolist(), segs.tolist())):
            rs = refs.readsets[seg]
            rr = refs.starts[seg] + (wr - int(offs[seg]))
            c0, c1 = int(rs.cigar_off[rr]), int(rs.cigar_off[rr + 1])
            flats.append(rs.cigar_flat[c0:c1])
            lens[j] = c1 - c0
    else:
        for j, wr in enumerate(rows.tolist()):
            rs, rr = refs[wr]
            c0, c1 = int(rs.cigar_off[rr]), int(rs.cigar_off[rr + 1])
            flats.append(rs.cigar_flat[c0:c1])
            lens[j] = c1 - c0
    nsm_idx[rows] = np.arange(len(rows), dtype=np.int32)
    nsm_flat = np.ascontiguousarray(np.concatenate(flats), np.uint32)
    nsm_off = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
    return nsm_idx, nsm_flat, nsm_off


def compute_vcf_info(call: WindowCall, ref_file, config: PlatypusConfig) -> Dict[Variant, dict]:
    """Per-variant INFO dict (vcfutils.pyx:1226-1459)."""
    reads = call.reads
    hap_score = compute_haplotype_score(call)

    # Haplotype-level seeds: FR/PP/HP/SC (vcfutils.pyx:1118-1152).
    info: Dict[Variant, dict] = {}
    for hap_index, hap in enumerate(call.haplotypes):
        seed = hap.vcf_info_seed()
        for var, value in seed.items():
            if var not in call.variant_posteriors:
                continue
            if var not in info:
                info[var] = dict(
                    HP=value["HP"],
                    PP=["%.0f" % call.variant_posteriors[var]],
                    FR=[float(call.frequencies[hap_index])],
                    SC=value["SC"],
                )
            else:
                info[var]["FR"][0] += float(call.frequencies[hap_index])

    hap_var_sets = call.hap_var_sets

    n_ind = len(call.n_reads)
    good_rows_by_ind = [
        np.nonzero((reads.sample_idx == i) & reads.is_good)[0] for i in range(n_ind)
    ]
    bad_rows_by_ind = [
        np.nonzero((reads.sample_idx == i) & ~reads.is_good & ~reads.is_broken)[0]
        for i in range(n_ind)
    ]
    n_good = sum(len(r) for r in good_rows_by_ind)
    n_bad = sum(len(r) for r in bad_rows_by_ind)

    single_m = reads.single_m()
    exact_indels = bool(config.count_only_exact_indel_matches)
    col = np.arange(reads.qual.shape[1]) if reads.qual.size else np.zeros(0, np.int64)

    # Native fast path: the whole per-(variant, individual) accounting loop
    # runs in one C++ call (ptpu_info_accumulate); the numpy body below is
    # the fallback and oracle.
    info_ctx = None
    if native.load() is not None and reads.qual.size:
        # The region gather precomputes the non-single-M CSR (shared flat
        # tables + one idx gather per window); windows built outside the
        # region matrix derive it here.
        nsm = reads.nsm_ctx or _window_nsm_csr(reads)
        info_ctx = native.native_info_context(reads, *nsm)
    use_native_info = info_ctx is not None

    # Cumulative count of low-qual (<5) columns per read: turns each
    # variant's "all quals >= 5 in span" check from an [R, L] mask into two
    # gathers (computed once per window, used per variant x individual).
    # Fallback-path only — the native pass checks spans directly.
    L = reads.qual.shape[1]
    lowq_cum = np.zeros((0, 0), np.int32)
    if reads.qual.size and not use_native_info:
        lowq_cum = np.zeros((len(reads.qual), L + 1), np.int32)
        np.cumsum(reads.qual < 5, axis=1, out=lowq_cum[:, 1:])

    def overlap_qualgood(rows: np.ndarray, var_min: int, var_max: int) -> np.ndarray:
        """Rows overlapping [var_min, var_max] whose quals in the variant
        span are all >= 5 (the scalar helpers' semantics, batched)."""
        if len(rows) == 0:
            return rows
        pos = reads.pos[rows]
        m = (pos <= var_max) & (reads.end[rows] > var_min)
        rows = rows[m]
        if len(rows) == 0:
            return rows
        pos = pos[m]
        rlen = reads.rlen[rows].astype(np.int64)
        lo = np.clip(var_min - pos, 0, rlen)
        hi = np.clip(var_max - pos, 0, rlen)
        n_low = (lowq_cum[rows, np.maximum(hi, lo)] - lowq_cum[rows, lo])
        return rows[n_low == 0]

    def supported_mask(rows: np.ndarray, variant: Variant) -> np.ndarray:
        """variant_supported_by_read over many rows: single-M cigars (the
        common case) vectorise; anything with indels/clips re-walks."""
        out = np.zeros(len(rows), bool)
        sm = single_m[rows]
        n_add = variant.n_added
        if variant.n_added == variant.n_removed and sm.any():
            # M-only walk: ref_off = read_off = 0.
            srows = rows[sm]
            pos = reads.pos[srows]
            rlen = reads.rlen[srows].astype(np.int64)
            start = variant.ref_pos - pos
            cand = (start >= 0) & (start + n_add <= rlen) & (start < rlen)
            if cand.any():
                gather = np.clip(start[:, None] + np.arange(n_add)[None, :], 0,
                                 reads.seq.shape[1] - 1)
                eq = (reads.seq[srows[:, None], gather]
                      == np.frombuffer(variant.added, np.uint8)[None, :]).all(axis=1)
                res = cand & eq
            else:
                res = np.zeros(len(srows), bool)
            out[sm] = res
        # Indels never match an M-only cigar; re-walk the rest — in C++ when
        # the native library and the lazy segment refs are available.
        nsm = np.nonzero(~sm)[0]
        if len(nsm) == 0:
            return out
        refs = reads.cigar_refs
        offs = getattr(refs, "offsets", None)
        if offs is not None and native.load() is not None:
            wrows = rows[nsm].astype(np.int64)
            segs = np.searchsorted(offs, wrows, side="right") - 1
            res = np.zeros(len(wrows), bool)
            for seg in np.unique(segs):
                rs = refs.readsets[seg]
                m = segs == seg
                rs_rows = refs.starts[seg] + (wrows[m] - offs[seg])
                res[m] = native.native_variant_supported(
                    rs.cigar_flat, rs.cigar_off, reads.seq, reads.rlen,
                    reads.pos, rs_rows, wrows[m], variant.ref_pos,
                    variant.added, variant.n_removed, exact_indels,
                )
            out[nsm] = res
            return out
        for j in nsm:
            r = int(rows[j])
            rs, row = refs[r]
            out[j] = variant_supported_by_read(
                rs.cigar_ops(row), reads.seq[r], int(reads.rlen[r]),
                int(reads.pos[r]), variant, exact_indels,
            )
        return out

    for variant, vinfo in info.items():
        var_min = variant.bam_min_pos
        var_max = variant.bam_max_pos
        tc = tc_bad = tr = 0
        tc_ab = tr_ab = 0
        nf = nr = nf_sb = nr_sb = 0
        tcf = tcr = tcf_sb = tcr_sb = 0
        rmsmq = 0.0
        min_quals: List[int] = []
        n_reads_per_sample: List[int] = []
        n_var_reads_per_sample: List[int] = []

        for i in range(n_ind):
            gt_idx = call.genotype_calls[i]
            var_in_genotype = False
            if gt_idx is not None:
                h1 = call.hap1_idx[gt_idx]
                h2 = call.hap2_idx[gt_idx]
                var_in_genotype = variant in hap_var_sets[h1] or variant in hap_var_sets[h2]

            if use_native_info:
                c, rms, minq, alt_d, ref_d = native.native_info_accumulate(
                    info_ctx, good_rows_by_ind[i], bad_rows_by_ind[i],
                    var_min, var_max, variant.ref_pos, variant.added,
                    variant.n_removed, exact_indels, var_in_genotype,
                    config.bad_reads_window,
                )
                cl = c.tolist()  # one conversion instead of 13 int() calls
                tc += cl[0]; tc_bad += cl[1]; tr += cl[2]
                tc_ab += cl[3]; tr_ab += cl[4]; nf += cl[5]
                nr += cl[6]; nf_sb += cl[7]; nr_sb += cl[8]
                tcf += cl[9]; tcr += cl[10]; tcf_sb += cl[11]
                tcr_sb += cl[12]; rmsmq += rms
                min_quals.extend(minq)
                n_reads_per_sample.append(cl[0])
                n_var_reads_per_sample.append(cl[2])
                continue

            brows = overlap_qualgood(bad_rows_by_ind[i], var_min, var_max)
            tc_bad += len(brows)
            if len(brows):
                rmsmq += float((reads.mapq[brows].astype(np.float64) ** 2).sum())

            grows = overlap_qualgood(good_rows_by_ind[i], var_min, var_max)
            n_reads_this = len(grows)
            tc += n_reads_this
            if n_reads_this:
                rmsmq += float((reads.mapq[grows].astype(np.float64) ** 2).sum())
            rev = reads.strand_reverse[grows].astype(bool)
            n_rev = int(rev.sum())
            tcr += n_rev
            tcf += n_reads_this - n_rev
            if var_in_genotype:
                tc_ab += n_reads_this
                tcr_sb += n_rev
                tcf_sb += n_reads_this - n_rev

            supp = supported_mask(grows, variant)
            srows = grows[supp]
            srev = rev[supp]
            n_var_reads_this = len(srows)
            tr += n_var_reads_this
            n_srev = int(srev.sum())
            nr += n_srev
            nf += n_var_reads_this - n_srev
            if var_in_genotype:
                tr_ab += n_var_reads_this
                nr_sb += n_srev
                nf_sb += n_var_reads_this - n_srev
                if n_var_reads_this:
                    w = config.bad_reads_window
                    pos = reads.pos[srows]
                    rlen = reads.rlen[srows].astype(np.int64)
                    w_start = np.maximum(0, var_min - pos - (w - 1) // 2)
                    w_end = np.minimum(rlen, var_max - pos + (w - 1) // 2)
                    span = (col[None, :] >= w_start[:, None]) & (col[None, :] < w_end[:, None])
                    mins = np.where(span, reads.qual[srows], 255).min(axis=1, initial=255)
                    mins = np.where(w_end > w_start, mins, 0)
                    min_quals.extend(int(x) for x in mins)

            n_reads_per_sample.append(n_reads_this)
            n_var_reads_per_sample.append(n_var_reads_this)

        # ReadPosRankSum is declared in the reference's INFO header but
        # NEVER computed for variant lines (only a "." placeholder on
        # REFCALL blocks, variantcaller.pyx:844) — verified by running the
        # reference itself (docs/REFERENCE_RUN.md).  The Mann-Whitney
        # machinery stays available in utils/maths for the offline tools.
        vinfo["ABPV"] = [round_ref(allele_bias_pvalue(tc_ab, tr_ab), 2)]
        vinfo["SbPval"] = [round_ref(strand_bias_pvalue(tcf_sb, tcr_sb, nf_sb, nr_sb), 2)]
        vinfo["TR"] = [tr]
        vinfo["NF"] = [nf]
        vinfo["NR"] = [nr]
        if tr > 0:
            qual = float(vinfo["PP"][0])
            if qual > 2500:
                vinfo["QD"] = [config.qd_threshold + 10]
            else:
                prior = variant.calculate_prior(ref_file)
                vinfo["QD"] = [(qual + (-10 * math.log10(prior))) / tr]
        else:
            vinfo["QD"] = [0]
        vinfo["BRF"] = [round_ref(n_bad / max(1, n_good + n_bad), 2)]
        vinfo["TC"] = [tc]
        vinfo["TCR"] = [tcr]
        vinfo["TCF"] = [tcf]
        if tc + tc_bad > 0 and rmsmq > 0:
            vinfo["MQ"] = [round_ref(math.sqrt(rmsmq / (tc + tc_bad)), 2)]
        else:
            vinfo["MQ"] = [0]
        vinfo["nReadsPerSample"] = n_reads_per_sample
        vinfo["nVarReadsPerSample"] = n_var_reads_per_sample
        vinfo["FR"][0] = "%1.4f" % vinfo["FR"][0]
        vinfo["HapScore"] = [hap_score]
        min_quals.sort()
        if min_quals:
            vinfo["MMLQ"] = [min_quals[len(min_quals) // 2]]
        else:
            vinfo["MMLQ"] = [100]
        source = []
        if variant.var_source & PLATYPUS_VAR:
            source.append("Platypus")
        if variant.var_source & ASSEMBLER_VAR:
            source.append("Assembler")
        if variant.var_source & FILE_VAR:
            source.append("File")
        vinfo["Source"] = source

    return info


def compute_vcf_filter(call: WindowCall, info: Dict[Variant, dict],
                       config: PlatypusConfig) -> Dict[Variant, List[str]]:
    """vcfutils.pyx:1502-1627 (all-alleles-must-fail semantics)."""
    out: Dict[Variant, List[str]] = {}
    for pos, vars_at_pos in call.vars_by_pos.items():
        n_vars = len(vars_at_pos)
        n_qd = n_hapscore = n_sb = n_ab = n_rmsmq = n_mmlq = 0
        best_qual = 0
        brf = 0.0
        sequence = info[vars_at_pos[0]]["SC"][0]
        fails_sc = compute_sc_value(sequence) > config.sc_threshold

        for v in vars_at_pos:
            out[v] = []
            iv = info[v]
            hap_sc = int(iv["HapScore"][0])
            qd = float(iv["QD"][0])
            brf = float(iv["BRF"][0])
            rmsmq = float(iv["MQ"][0])
            total_reads = int(iv["TC"][0])
            med_min = int(iv.get("MMLQ", [100])[0])
            this_qual = int(float(iv.get("PP", [0])[0]))
            if this_qual > best_qual:
                best_qual = this_qual
            if med_min < config.bad_reads_threshold:
                n_mmlq += 1
            ab_pval = float(iv["ABPV"][0])
            sb_pval = float(iv["SbPval"][0])
            if qd < config.qd_threshold:
                n_qd += 1
            if hap_sc > config.hap_score_threshold:
                n_hapscore += 1
            if total_reads > 0 and ab_pval < config.ab_threshold:
                n_ab += 1
            if sb_pval < config.sb_threshold:
                n_sb += 1
            if rmsmq < config.rmsmq_threshold:
                n_rmsmq += 1
            if fails_sc:
                out[v].append("SC")

        for v in vars_at_pos:
            if n_qd == n_vars:
                out[v].append("QD")
            if n_hapscore == n_vars:
                out[v].append("HapScore")
            if n_rmsmq == n_vars:
                out[v].append("MQ")
            if n_sb == n_vars:
                out[v].append("strandBias")
            if n_ab == n_vars:
                out[v].append("alleleBias")
            if n_mmlq == n_vars or brf >= config.filtered_reads_frac:
                out[v].append("badReads")
            if best_qual < 20:
                out[v].append("Q20")
    return out


# ---------------------------------------------------------------------------
# REF/ALT and genotype output
# ---------------------------------------------------------------------------

def ref_and_alt(chrom: str, pos: int, variants: List[Variant], ref_file) -> Tuple[str, List[str]]:
    """vcfutils.pyx:843-897."""
    non_snp = any(v.n_removed != 1 or v.n_added != 1 for v in variants)
    indel = any(v.n_removed != v.n_added for v in variants)
    if not non_snp:
        ref = ref_file.get_character(chrom, pos).decode()
        return ref, [v.added.decode() for v in variants]
    rlen = max(v.n_removed for v in variants)
    if indel:
        ref = ref_file.get_sequence(chrom, pos, pos + rlen + 1).decode()
    else:
        ref = ref_file.get_sequence(chrom, pos, pos + rlen).decode()
    alts = []
    for v in variants:
        seq = list(ref)
        if v.n_removed == v.n_added:
            seq[0 : v.n_added] = v.added.decode()
        else:
            seq[1 : 1 + v.n_removed] = v.added.decode()
        alts.append("".join(seq))
    return ref, alts


def trim_left_padding(pos: int, ref: str, alts: List[str]) -> Tuple[int, str, List[str]]:
    """vcfutils.pyx:796-839."""
    if not alts:
        return pos, ref, alts
    min_len = min(len(ref), min(len(a) for a in alts))
    max_len_diff = max(abs(len(ref) - len(a)) for a in alts)
    for _ in range(1, min_len):
        first_alt = {a[0].upper() for a in alts}
        second_alt = {a[1].upper() for a in alts if len(a) > 1}
        if len(first_alt) > 1 or ref[0].upper() != next(iter(first_alt)):
            break
        if max_len_diff > 0 and (len(second_alt) > 1 or
                                 (second_alt and ref[1] != next(iter(second_alt)))):
            break
        ref = ref[1:]
        alts = [a[1:] for a in alts]
        pos += 1
    return pos, ref, alts


_GT_NATIVE_OK: Optional[bool] = None


def _native_gt_verified() -> bool:
    """First-use bit-exactness self-check of the C++ genotype kernel vs the
    Python oracle over randomized windows (same protocol as the EM twin)."""
    global _GT_NATIVE_OK
    if _GT_NATIVE_OK is None:
        _GT_NATIVE_OK = False
        if os.environ.get("PLATYPUS_TPU_NATIVE_GT", "1") != "0" \
                and native.load() is not None:
            _GT_NATIVE_OK = _verify_native_gt()
            if not _GT_NATIVE_OK:
                import logging

                logging.getLogger("platypus_tpu").warning(
                    "native genotype kernel failed the bit-exactness "
                    "self-check; using the Python oracle")
    return _GT_NATIVE_OK


class _FakeCall:
    """Minimal WindowCall stand-in for the self-check."""
    __slots__ = ("likelihoods", "frequencies", "hap1_idx", "hap2_idx", "gof")

    def __init__(self, likelihoods, frequencies, hap1_idx, hap2_idx, gof):
        self.likelihoods = likelihoods
        self.frequencies = frequencies
        self.hap1_idx = hap1_idx
        self.hap2_idx = hap2_idx
        self.gof = gof


def _verify_native_gt() -> bool:
    from ..ops.likelihood import genotype_index_pairs

    rng = np.random.default_rng(20260820)
    for _ in range(60):
        H = int(rng.integers(1, 14))
        I = int(rng.integers(1, 6))
        n_vars = int(rng.integers(1, 4))
        n_ind = I if rng.random() < 0.8 else 30
        h1, h2 = genotype_index_pairs(H)
        G = len(h1)
        lik = np.maximum(1e-300, rng.random((I, G)))
        freqs = rng.random(H)
        gof = rng.uniform(0, 50, (G, I))
        hap_is_ref = (rng.random(H) < 0.5).astype(np.int64)
        var_in_hap = rng.random((H, n_vars)) < 0.5
        call = _FakeCall(lik, freqs, h1, h2, gof)
        i = int(rng.integers(0, I))
        variants = [None] * n_vars
        want = _compute_genotype_call_and_likelihoods_py(
            call, i, variants, hap_is_ref, var_in_hap, n_ind)
        got = _genotype_call_native(call, i, variants, hap_is_ref,
                                    var_in_hap, n_ind)
        if got is None:
            return False
        if want[0] != got[0] or want[1] != got[1]:
            return False
        if np.asarray(want[2]).tobytes() != np.asarray(got[2]).tobytes():
            return False
        if np.asarray(want[3:]).tobytes() != np.asarray(got[3:]).tobytes():
            return False
    return True


def _genotype_call_native(call, sample_index, variants_this_pos,
                          hap_is_ref_at_pos, var_in_hap, n_individuals):
    # getattr: tests stub the `native` module out to force the Python
    # path; the verified-flag cache must not defeat the stub.
    fn = getattr(native, "native_genotype_call", None)
    if fn is None:
        return None
    res = fn(
        call.likelihoods[sample_index], call.frequencies,
        call.hap1_idx, call.hap2_idx, hap_is_ref_at_pos, var_in_hap,
        call.gof, sample_index, n_individuals)
    if res is None:
        return None
    lik_out, phased, scalars = res
    best_likelihood, non_ref_post, ref_post, sum_lik, best_gof = scalars.tolist()
    if sum_lik == 0:
        sum_lik = 1.0
    return (
        int(phased[0]), int(phased[1]), lik_out.tolist(),
        best_likelihood / sum_lik, non_ref_post / sum_lik,
        ref_post / sum_lik, best_gof,
    )


def compute_genotype_call_and_likelihoods(
    call: WindowCall,
    sample_index: int,
    variants_this_pos: List[Variant],
    hap_is_ref_at_pos: np.ndarray,       # [H] int
    var_in_hap: np.ndarray,              # [H, nVars] bool
    n_individuals: int,
):
    """vcfutils.pyx:163-334 — dispatches to the C++ kernel (genotype.cpp,
    bit-exact, self-checked at first use) with the Python body below as
    the oracle and fallback."""
    if _native_gt_verified():
        res = _genotype_call_native(call, sample_index, variants_this_pos,
                                    hap_is_ref_at_pos, var_in_hap,
                                    n_individuals)
        if res is not None:
            return res
    return _compute_genotype_call_and_likelihoods_py(
        call, sample_index, variants_this_pos, hap_is_ref_at_pos,
        var_in_hap, n_individuals)


def _compute_genotype_call_and_likelihoods_py(
    call: WindowCall,
    sample_index: int,
    variants_this_pos: List[Variant],
    hap_is_ref_at_pos: np.ndarray,       # [H] int
    var_in_hap: np.ndarray,              # [H, nVars] bool
    n_individuals: int,
):
    """vcfutils.pyx:163-334."""
    n_vars = len(variants_this_pos)
    lik = call.likelihoods[sample_index]      # [G]
    freqs = call.frequencies
    h1 = call.hap1_idx
    h2 = call.hap2_idx
    factor = np.where(h1 != h2, 2.0, 1.0)
    if n_individuals > 25:
        base = factor * freqs[h1] * freqs[h2] * lik
    else:
        base = factor * lik

    hap1_ref = hap_is_ref_at_pos[h1].astype(bool)
    hap2_ref = hap_is_ref_at_pos[h2].astype(bool)

    likelihoods = []
    best_likelihood = -1.0
    best_gof = 1e6
    phased1 = phased2 = -1
    phased_max = -1e6
    non_ref_post = 0.0
    ref_post = 0.0
    sum_lik = 0.0
    gof_col = call.gof[:, sample_index]

    for index1 in range(n_vars + 1):
        for index2 in range(index1 + 1):
            if index1 == 0 and index2 == 0:
                match = hap1_ref & hap2_ref
            elif index2 == 0:
                v1h1 = var_in_hap[h1, index1 - 1]
                v1h2 = var_in_hap[h2, index1 - 1]
                match = (hap2_ref & v1h1) | (hap1_ref & v1h2)
            else:
                v1h1 = var_in_hap[h1, index1 - 1]
                v1h2 = var_in_hap[h2, index1 - 1]
                v2h1 = var_in_hap[h1, index2 - 1]
                v2h2 = var_in_hap[h2, index2 - 1]
                match = (v1h1 & v2h2) | (v2h1 & v1h2)

            if match.any():
                cur = np.where(match, base, -np.inf)
                marginal = float(base[match].sum())
                g_best = int(np.argmax(cur))
                cur_best = float(cur[g_best])
                if cur_best > phased_max:
                    phased_max = cur_best
                    if index1 == 0 and index2 == 0:
                        phased1, phased2 = 0, 0
                    elif index2 == 0:
                        if var_in_hap[h1[g_best], index1 - 1]:
                            phased1, phased2 = index1, index2
                        elif var_in_hap[h2[g_best], index1 - 1]:
                            phased1, phased2 = index2, index1
                    elif index1 == index2:
                        phased1, phased2 = index1, index2
                    else:
                        if (var_in_hap[h1[g_best], index1 - 1]
                                and var_in_hap[h2[g_best], index2 - 1]):
                            phased1, phased2 = index1, index2
                        elif (var_in_hap[h2[g_best], index1 - 1]
                                and var_in_hap[h1[g_best], index2 - 1]):
                            phased1, phased2 = index2, index1
                mg = float(gof_col[match].min())
                if mg < best_gof:
                    best_gof = mg
            else:
                marginal = 0.0

            if marginal > best_likelihood:
                best_likelihood = marginal
            if (index1 == 1 and index2 == 0) or (index1 == 1 and index2 == 1):
                non_ref_post += marginal
            elif index1 == 0 and index2 == 0:
                ref_post += marginal
            sum_lik += marginal
            likelihoods.append(marginal)

    if sum_lik == 0:
        sum_lik = 1.0
    return (
        phased1, phased2, likelihoods,
        best_likelihood / sum_lik, non_ref_post / sum_lik, ref_post / sum_lik,
        best_gof,
    )


# ---------------------------------------------------------------------------
# Full window output
# ---------------------------------------------------------------------------

def output_call_to_vcf(
    call: WindowCall,
    buffers,
    ref_file,
    config: PlatypusConfig,
    writer: VCFWriter,
) -> int:
    """Emit VCF records for a called window (vcfutils.pyx:338-599).
    Returns the number of lines written."""
    if not call.variant_posteriors:
        return 0
    info = compute_vcf_info(call, ref_file, config)
    vcf_filter = compute_vcf_filter(call, info, config)

    haplotypes = call.haplotypes
    H = len(haplotypes)
    hap_var_sets = call.hap_var_sets
    all_variants = list(call.window.variants)
    n_written = 0

    for pos in sorted(call.vars_by_pos.keys()):
        variants = call.vars_by_pos[pos]
        n_vars = len(variants)

        hap_is_ref = np.ones(H, np.int64)
        var_in_hap = np.zeros((H, n_vars), bool)
        for h in range(H):
            for vi, v in enumerate(variants):
                if v in hap_var_sets[h]:
                    var_in_hap[h, vi] = True
                    if v.min_ref_pos <= pos <= v.max_ref_pos:
                        hap_is_ref[h] = 0
            for v in all_variants:
                if v in hap_var_sets[h] and v.min_ref_pos <= pos <= v.max_ref_pos:
                    hap_is_ref[h] = 0

        chrom = variants[0].ref_name
        ref, alts = ref_and_alt(chrom, pos, variants, ref_file)

        line_filter: List[str] = []
        line_info = dict(info[variants[0]])
        fr: List = []
        pp: List = []
        nf: List = []
        nr: List = []
        tr: List = []
        for v in variants:
            line_filter.extend(f for f in vcf_filter[v] if f in FILTER_NAMES)
            fr.extend(info[v]["FR"])
            pp.extend(info[v]["PP"])
            nr.extend(info[v]["NR"])
            nf.extend(info[v]["NF"])
            tr.extend(info[v]["TR"])
        line_info["WS"] = [call.window.start_pos]
        line_info["WE"] = [call.window.end_pos]
        line_info["FR"] = fr
        line_info["PP"] = pp
        line_info["NF"] = nf
        line_info["NR"] = nr
        line_info["TR"] = tr
        line_filter = sorted(set(line_filter))
        qual = max(int(float(p)) for p in line_info["PP"])

        sample_data: Dict[str, Dict[str, list]] = {}
        max_gof = 0.0
        n_non_ref_calls = 0

        for i, buf in enumerate(buffers):
            sample = buf.sample
            if call.n_reads[i] == 0:
                sample_data[sample] = dict(
                    GT=[[".", "/", "."]], GL=[0, 0, 0], GQ=[0], GOF=[0], NR=[0], NV=[0]
                )
                continue
            (
                index1, index2, likelihoods, genotype_post, non_ref_post,
                ref_post, gof_value,
            ) = compute_genotype_call_and_likelihoods(
                call, i, variants, hap_is_ref, var_in_hap, len(buffers)
            )
            if not (index1 == 0 and index2 == 0):
                n_non_ref_calls += 1
            gt = [str(index1), "/", str(index2)]
            phred_post = int(min(99, round_ref(-10.0 * math.log10(max(1e-10, 1.0 - genotype_post)))))
            phred_non_ref = int(min(99, round_ref(-10.0 * math.log10(max(1e-10, 1.0 - non_ref_post)))))
            phred_ref = int(min(99, round_ref(-10.0 * math.log10(max(1e-10, 1.0 - ref_post)))))

            if n_vars == 1 and phred_non_ref < config.min_posterior and phred_ref < config.min_posterior:
                gt = [".", "/", "."]
            elif n_vars == 1 and phred_non_ref < config.min_posterior:
                gt = ["0", "/", "0"]

            if n_vars == 1:
                max_like = max(likelihoods)
                gls = [round_ref(math.log10(max(x / max_like, 1e-300)), 2) for x in likelihoods]
            else:
                gls = [-1, -1, -1]

            reads_per_sample = [info[v]["nReadsPerSample"][i] for v in variants]
            var_reads_per_sample = [info[v]["nVarReadsPerSample"][i] for v in variants]

            if n_vars == 1 and reads_per_sample[0] < config.min_reads:
                gt = [".", "/", "."]
            sample_data[sample] = dict(
                GT=[gt], GL=gls, GQ=[phred_post], GOF=[int(gof_value)],
                NR=reads_per_sample, NV=var_reads_per_sample,
            )
            if gof_value > max_gof:
                max_gof = gof_value

        line_info.pop("nReadsPerSample", None)
        line_info.pop("nVarReadsPerSample", None)
        line_info.pop("ABPV", None)
        line_info["MGOF"] = [int(round_ref(max_gof, 2))]

        if n_non_ref_calls > 0 or config.min_posterior == 0 or config.output_ref_calls == 1:
            out_pos, out_ref, out_alts = trim_left_padding(pos, ref, alts)
            if any(ord(c) not in CANONICAL for c in out_ref):
                continue
            writer.write_record(
                chrom, out_pos, out_ref, out_alts, qual, line_filter,
                line_info, ["GT", "GL", "GOF", "GQ", "NR", "NV"], sample_data,
            )
            n_written += 1
    return n_written
