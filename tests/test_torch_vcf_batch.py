"""The VCF output's native parts (platypus_tpu_torch/native): a window's
INFO accounting (ptpu_info_accumulate_window) and a position's genotype
calls (ptpu_genotype_call_samples), which the window entry ptpu_vcf_window
runs, each held bitwise to the Python route used where the library does
not load (the numpy INFO body; the genotype body per sample); a loaded
library sends every window to the window entry, and a port run on a
3-sample cohort counts how many accountings each crossing covers."""

import types

import numpy as np
import pytest

from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch import native
from platypus_tpu_torch.candidates.variant import Variant
from platypus_tpu_torch.engine import region as region_mod
from platypus_tpu_torch.ops.likelihood import genotype_index_pairs
from platypus_tpu_torch.utils.observability import GLOBAL_METRICS
from platypus_tpu_torch.vcfout import records
from test_torch_smoke_data import cohort_dataset

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="the port's native library did not build")

BASES = np.frombuffer(b"ACGT", np.uint8)
M, I_OP, D, S = 0, 1, 2, 4


def _cigar(ops):
    return [(length << 4) | op for op, length in ops]


def _random_window(rng, n_ind):
    """Reads of n_ind individuals over ~500 bp: single-M rows and rows with
    soft clips, insertions and deletions, good, bad and broken rows, quals
    with some under 5; and SNVs, insertions and deletions among them."""
    R = int(rng.integers(n_ind * 3, n_ind * 8 + 1))
    L = 100
    rlen = rng.integers(60, L + 1, R).astype(np.int32)
    pos = rng.integers(0, 400, R).astype(np.int64)
    seq = rng.choice(BASES, (R, L))
    qual = rng.integers(3, 41, (R, L)).astype(np.uint8)
    qual[rng.random((R, L)) < 0.9] = 35
    single_m = rng.random(R) < 0.6
    nsm_rows = np.flatnonzero(~single_m)
    nsm_idx = np.full(R, -1, np.int32)
    flat, off = [], [0]
    for j, r in enumerate(nsm_rows):
        a = int(rng.integers(1, 30))
        ins = int(rng.integers(1, 4))
        kind = rng.integers(0, 3)
        if kind == 0:
            ops = [(S, int(rng.integers(1, 5))), (M, a), (I_OP, ins),
                   (M, max(1, int(rlen[r]) - a - ins - 4))]
        elif kind == 1:
            ops = [(M, a), (D, int(rng.integers(1, 5))), (M, int(rlen[r]) - a)]
        else:
            ops = [(M, a), (I_OP, ins), (M, int(rlen[r]) - a - ins)]
        flat.extend(_cigar(ops))
        off.append(len(flat))
        nsm_idx[r] = j
    reads = types.SimpleNamespace(
        seq=np.ascontiguousarray(seq), qual=np.ascontiguousarray(qual),
        pos=pos, end=pos + rlen, rlen=rlen,
        mapq=rng.integers(0, 61, R).astype(np.int32),
        strand_reverse=rng.random(R) < 0.5,
        sample_idx=np.sort(rng.integers(0, n_ind, R)).astype(np.int32),
        is_good=rng.random(R) < 0.8,
        is_broken=rng.random(R) < 0.3)
    reads.single_m = lambda: single_m
    nsm = (nsm_idx, np.array(flat or [0], np.uint32), np.array(off, np.int64))

    V = int(rng.integers(1, 7))
    variants = []
    for _ in range(V):
        ref_pos = int(rng.integers(5, 480))
        kind = rng.integers(0, 3)
        if kind == 0:  # SNV: often a base some read carries there
            carriers = np.flatnonzero((pos <= ref_pos) & (pos + rlen > ref_pos))
            if len(carriers) and rng.random() < 0.7:
                r = int(rng.choice(carriers))
                added = bytes([int(seq[r, ref_pos - pos[r]])])
            else:
                added = bytes([int(rng.choice(BASES))])
            n_removed = 1
        elif kind == 1:  # insertion
            added = bytes(rng.choice(BASES, int(rng.integers(1, 4))))
            n_removed = 0
        else:  # deletion
            added = b""
            n_removed = int(rng.integers(1, 5))
        variants.append((ref_pos - 1, ref_pos + n_removed + 1, ref_pos,
                         added, n_removed))
    var_in_genotype = rng.random((V, n_ind)) < 0.5
    return reads, nsm, variants, var_in_genotype


class _Cigars:
    """The window's non-single-M CIGARs as the rows of one read set:
    cigar_refs[r] = (this, its CSR index), as io/bam.ReadSet serves them."""

    def __init__(self, flat, off):
        self.cigar_flat, self.cigar_off = flat, off

    def cigar_ops(self, i):
        words = self.cigar_flat[self.cigar_off[i]:self.cigar_off[i + 1]]
        return np.stack([words & 0xF, words >> 4], axis=1).astype(np.int64)


def _info_window(rng, n_ind):
    """_random_window as the INFO routes take it: (reads, call, variants)
    with the reads' CIGARs behind cigar_refs, and a call whose genotype of
    individual i is haplotype i twice, carrying the variants its column
    of var_in_genotype marks (none called where the column is empty)."""
    reads, nsm, specs, vig = _random_window(rng, n_ind)
    nsm_idx, flat, off = nsm
    cigars = _Cigars(flat, off)
    reads.cigar_refs = [(cigars, int(j)) if j >= 0 else None for j in nsm_idx]
    # Half the windows carry the region's CSR, half derive it from the refs.
    reads.nsm_ctx = nsm if rng.random() < 0.5 else None
    variants = []
    for var_min, var_max, var_pos, added, n_removed in specs:
        v = Variant("chr20", var_pos, b"A" * n_removed, added)
        v.bam_min_pos, v.bam_max_pos = var_min, var_max
        variants.append(v)
    idx = np.arange(n_ind)
    call = types.SimpleNamespace(
        n_reads=np.ones(n_ind, np.int64), hap1_idx=idx, hap2_idx=idx,
        genotype_calls=[i if vig[:, i].any() else None for i in range(n_ind)],
        hap_var_sets=[{v for k, v in enumerate(variants) if vig[k, i]}
                      for i in range(n_ind)])
    return reads, call, variants


def _info_accounts_native(reads, call, variants, config):
    """The window entry's INFO accounting (ptpu_info_accumulate_window) in
    the form records._info_accounts_numpy returns."""
    info_ctx = native.native_info_context(
        reads, *(reads.nsm_ctx or records._window_nsm_csr(reads)))
    n_ind = len(call.n_reads)
    counters, rms, min_quals, n_good, n_bad = native.native_info_accumulate_window(
        info_ctx, n_ind,
        np.array([(v.bam_min_pos, v.bam_max_pos, v.ref_pos, v.n_removed,
                   v.n_added) for v in variants], np.int64).reshape(-1, 5),
        b"".join(v.added for v in variants),
        records._var_in_genotype(call, variants),
        bool(config.count_only_exact_indel_matches), config.bad_reads_window)
    min_quals = min_quals.tolist()
    lo = 0
    out = []
    for rows, rms_row in zip(counters.tolist(), rms.tolist()):
        # MQ's fold: per individual, in individual order, from 0.0.
        rmsmq = 0.0
        for x in rms_row:
            rmsmq += x
        cols = list(zip(*rows))
        hi = lo + sum(cols[13])
        out.append(([sum(c) for c in cols[:13]], rmsmq,
                    sorted(min_quals[lo:hi]), list(cols[0]), list(cols[2])))
        lo = hi
    return out, n_good, n_bad


@pytest.mark.parametrize("n_ind", [1, 3, 16, 30])
def test_info_window_entry_matches_numpy_body(n_ind):
    """The window entry's accounts (per variant: the 13 totals, MQ's sum,
    the sorted min quals, reads and variant reads per sample; the good and
    bad row counts) equal the numpy body's, which walks the CIGARs in
    Python, bit for bit."""
    rng = np.random.default_rng(1500 + n_ind)
    for trial in range(12):
        reads, call, variants = _info_window(rng, n_ind)
        if trial % 2:  # rows not ordered by individual
            reads.sample_idx = rng.permutation(reads.sample_idx)
        config = types.SimpleNamespace(
            count_only_exact_indel_matches=int(rng.random() < 0.5),
            bad_reads_window=int(rng.choice([1, 7, 15])))
        want = records._info_accounts_numpy(reads, call, variants, config)
        got = _info_accounts_native(reads, call, variants, config)
        assert got == want, trial
        for (_t, rms_got, *_), (_t2, rms_want, *_) in zip(got[0], want[0]):
            assert np.float64(rms_got).tobytes() == np.float64(rms_want).tobytes()


def _random_gt_window(rng, n_ind_lo: int, n_ind_hi: int):
    """A randomized (call, hap_is_ref, var_in_hap, n_vars, I): n_vars 1-3,
    I in [n_ind_lo, n_ind_hi]."""
    H = int(rng.integers(1, 14))
    I = int(rng.integers(n_ind_lo, n_ind_hi + 1))
    n_vars = int(rng.integers(1, 4))
    h1, h2 = genotype_index_pairs(H)
    G = len(h1)
    call = types.SimpleNamespace(
        likelihoods=np.maximum(1e-300, rng.random((I, G))),
        frequencies=rng.random(H), hap1_idx=h1, hap2_idx=h2,
        gof=rng.uniform(0, 50, (G, I)))
    hap_is_ref = (rng.random(H) < 0.5).astype(np.int64)
    var_in_hap = rng.random((H, n_vars)) < 0.5
    return call, hap_is_ref, var_in_hap, n_vars, I


def _genotype_calls_native(ctx, samples, hap_is_ref, var_in_hap):
    """The genotype calls of the context's samples at one position
    (ptpu_genotype_call_samples): {sample: the Python body's tuple}."""
    rows = native.native_genotype_call_samples(
        ctx, hap_is_ref, var_in_hap).tolist()
    n_classes = len(rows[0]) - 7
    out = {}
    for i in samples:
        row = rows[i]
        (best_likelihood, non_ref_post, ref_post, sum_lik, best_gof,
         phased1, phased2) = row[n_classes:]
        if sum_lik == 0:
            sum_lik = 1.0
        out[i] = (int(phased1), int(phased2), row[:n_classes],
                  best_likelihood / sum_lik, non_ref_post / sum_lik,
                  ref_post / sum_lik, best_gof)
    return out


def _same_genotype_call(want, got) -> bool:
    return (want[0] == got[0] and want[1] == got[1]
            and np.asarray(want[2]).tobytes() == np.asarray(got[2]).tobytes()
            and np.asarray(want[3:]).tobytes() == np.asarray(got[3:]).tobytes())


@pytest.mark.parametrize("cohort", ["small", "large"])
def test_genotype_samples_entry_matches_python_oracle(cohort):
    """Sample by sample, bitwise, n_vars 1-3; I <= 25 and I > 25 (the
    frequency-weighted marginals); samples without reads left out."""
    rng = np.random.default_rng(15 if cohort == "small" else 16)
    for _trial in range(30):
        call, hap_is_ref, var_in_hap, n_vars, I = _random_gt_window(
            rng, *((1, 25) if cohort == "small" else (26, 40)))
        samples = [i for i in range(I) if rng.random() < 0.8]
        ctx = native.native_genotype_context(
            call.likelihoods, call.frequencies, call.hap1_idx, call.hap2_idx,
            call.gof, np.array(samples), I)
        got = _genotype_calls_native(ctx, samples, hap_is_ref, var_in_hap)
        assert sorted(got) == samples
        for i in samples:
            want = records._compute_genotype_call_and_likelihoods_py(
                call, i, [None] * n_vars, hap_is_ref, var_in_hap, I)
            assert _same_genotype_call(want, got[i]), (cohort, i)


# ---------------------------------------------------------------------------
# A port run on a 3-sample cohort
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort3(tmp_path_factory):
    return cohort_dataset(str(tmp_path_factory.mktemp("vcf_batch_cohort")),
                          3, 6000, 6)


def _run_port(info, out):
    GLOBAL_METRICS.reset()
    rc = port_cli.main(["callVariants", f"--bamFiles={info['bam']}",
                        f"--refFile={info['ref']}", f"--regions={info['region']}",
                        f"--logFileName={out}.log", "-o", out], device="cpu")
    assert rc == 0
    with open(out) as fh:
        lines = [line for line in fh if not line.startswith("#")]
    counters = GLOBAL_METRICS.counters
    return (lines, counters.get("vcf_native_calls", 0),
            counters.get("vcf_native_rows", 0),
            counters.get("vcf_native_windows", 0))


class _Stub:
    load = staticmethod(lambda auto_build=True: None)


def _count_windows(monkeypatch):
    """Count the windows that reach the VCF output with posteriors."""
    windows = []
    inner = region_mod.output_call_to_vcf

    def counting(call, *args):
        if call.variant_posteriors:
            windows.append(1)
        return inner(call, *args)

    monkeypatch.setattr(region_mod, "output_call_to_vcf", counting)
    return windows


def test_vcf_native_counters_and_stubbed_native(cohort3, tmp_path, monkeypatch):
    """One crossing a window covers its (variant, individual) accountings
    and (position, sample) calls; vcf_native_windows counts every window
    that reaches the VCF output.  With the library stubbed the Python route
    writes the same bytes and every counter reads 0."""
    windows = _count_windows(monkeypatch)
    lines, calls, rows, n_windows = _run_port(cohort3,
                                              str(tmp_path / "native.vcf"))
    assert len(lines) > 3
    assert calls > 0 and rows / calls >= 3
    assert n_windows == calls == len(windows)
    monkeypatch.setattr(records, "native", _Stub)
    py_lines, py_calls, py_rows, py_windows = _run_port(
        cohort3, str(tmp_path / "python.vcf"))
    assert (py_calls, py_rows, py_windows) == (0, 0, 0)
    assert py_lines == lines


def test_loaded_library_calls_every_position_natively(cohort3, tmp_path,
                                                     monkeypatch):
    """With the library loaded, the first window already goes to the window
    entry, one call a window that reaches the VCF output, whose lines are
    every line of the file, and the Python route is never called."""
    windows, written, python_calls = [], [], []
    inner = native.native_vcf_window

    def per_window(*args, **kwargs):
        out = inner(*args, **kwargs)
        windows.append(1)
        written.append(len(out[1]) // 2)
        return out

    def python_route(*args, **kwargs):
        python_calls.append(1)
        raise AssertionError("the Python route was called")

    reached = _count_windows(monkeypatch)
    monkeypatch.setattr(native, "native_vcf_window", per_window)
    monkeypatch.setattr(records, "_output_call_to_vcf_py", python_route)
    lines, _calls, _rows, _windows = _run_port(cohort3,
                                               str(tmp_path / "native.vcf"))
    assert lines and not python_calls
    assert len(windows) == len(reached)
    assert sum(written) == len(lines)
