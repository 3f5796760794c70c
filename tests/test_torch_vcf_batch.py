"""The VCF output's batched native entries (platypus_tpu_torch/native):
INFO accounting crosses into C++ once per window
(ptpu_info_accumulate_window) and genotype calls once per position
(ptpu_genotype_call_samples).  Each is held bitwise to the route it
replaces (one native_info_accumulate per (variant, individual); the Python
oracle per sample), and a port run on a 3-sample cohort counts how many
accountings each crossing covers."""

import types
from unittest import mock

import numpy as np
import pytest

from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch import native
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


@pytest.mark.parametrize("n_ind", [1, 3, 16, 30])
def test_info_window_entry_matches_per_pass_entry(n_ind):
    rng = np.random.default_rng(1500 + n_ind)
    for trial in range(12):
        reads, nsm, variants, vig = _random_window(rng, n_ind)
        if trial % 2:  # rows not ordered by individual
            reads.sample_idx = rng.permutation(reads.sample_idx)
        exact = bool(rng.random() < 0.5)
        window = int(rng.choice([1, 7, 15]))
        ctx = native.native_info_context(reads, *nsm)
        spec = np.array([(v[0], v[1], v[2], v[4], len(v[3])) for v in variants])
        counters, rms, min_quals, n_good, n_bad = native.native_info_accumulate_window(
            ctx, n_ind, spec, b"".join(v[3] for v in variants),
            vig.astype(np.uint8).tobytes(), exact, window)
        # The per-pass oracle takes each individual's rows as the 2 x I
        # masks of the per-pass route gave them.
        good = [np.flatnonzero((reads.sample_idx == i) & reads.is_good)
                for i in range(n_ind)]
        bad = [np.flatnonzero((reads.sample_idx == i) & ~reads.is_good
                              & ~reads.is_broken) for i in range(n_ind)]
        assert (n_good, n_bad) == (sum(map(len, good)), sum(map(len, bad)))
        lo = 0
        for k, (var_min, var_max, var_pos, added, n_removed) in enumerate(variants):
            folded_want = folded_got = 0.0
            for i in range(n_ind):
                c, r, mq, _alt, _ref = native.native_info_accumulate(
                    ctx, good[i], bad[i], var_min, var_max, var_pos, added,
                    n_removed, exact, bool(vig[k, i]), window)
                assert counters[k, i, :13].tolist() == c.tolist()
                assert counters[k, i, 13] == len(mq)
                assert np.float64(r).tobytes() == rms[k, i].tobytes()
                folded_want += r
                folded_got += float(rms[k, i])
                assert min_quals[lo:lo + len(mq)].tolist() == mq
                lo += len(mq)
            assert np.float64(folded_want).tobytes() == np.float64(folded_got).tobytes()
        assert lo == len(min_quals)


@pytest.mark.parametrize("cohort", ["small", "large"])
def test_genotype_samples_entry_matches_python_oracle(cohort):
    """Sample by sample, bitwise, n_vars 1-3; I <= 25 and I > 25 (the
    frequency-weighted marginals); samples without reads left out."""
    rng = np.random.default_rng(15 if cohort == "small" else 16)
    for _trial in range(30):
        call, hap_is_ref, var_in_hap, n_vars, I = records._random_gt_window(
            rng, *((1, 25) if cohort == "small" else (26, 40)))
        samples = [i for i in range(I) if rng.random() < 0.8]
        ctx = native.native_genotype_context(
            call.likelihoods, call.frequencies, call.hap1_idx, call.hap2_idx,
            call.gof, np.array(samples), I)
        got = records._genotype_calls_native(ctx, samples, hap_is_ref,
                                             var_in_hap)
        assert sorted(got) == samples
        for i in samples:
            want = records._compute_genotype_call_and_likelihoods_py(
                call, i, [None] * n_vars, hap_is_ref, var_in_hap, I)
            assert records._same_genotype_call(want, got[i]), (cohort, i)


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
    return lines, counters.get("vcf_native_calls", 0), counters.get("vcf_native_rows", 0)


class _Stub:
    load = staticmethod(lambda auto_build=True: None)


def test_vcf_native_counters_and_stubbed_native(cohort3, tmp_path, monkeypatch):
    lines, calls, rows = _run_port(cohort3, str(tmp_path / "native.vcf"))
    assert len(lines) > 3
    assert calls > 0 and rows / calls >= 3
    monkeypatch.setattr(records, "native", _Stub)
    py_lines, py_calls, py_rows = _run_port(cohort3, str(tmp_path / "python.vcf"))
    assert (py_calls, py_rows) == (0, 0)
    assert py_lines == lines


def test_failed_batch_self_check_calls_sample_by_sample(cohort3, tmp_path,
                                                        monkeypatch):
    lines, _calls, _rows = _run_port(cohort3, str(tmp_path / "batched.vcf"))

    def corrupted(*args, **kwargs):
        rows = native.native_genotype_call_samples(*args, **kwargs)
        rows[:, -3] += 1.0   # every best GOF off by one
        return rows

    corrupt_native = types.SimpleNamespace(
        **{k: getattr(native, k) for k in dir(native) if not k.startswith("__")})
    corrupt_native.native_genotype_call_samples = corrupted
    monkeypatch.setattr(records, "native", corrupt_native)
    monkeypatch.setattr(records, "_GT_NATIVE_OK", None)
    monkeypatch.setattr(records, "_GT_BATCH_OK", False)
    with mock.patch.object(corrupt_native, "native_genotype_call",
                           wraps=native.native_genotype_call) as per_sample:
        got, _calls, _rows = _run_port(cohort3, str(tmp_path / "fallback.vcf"))
        assert records._GT_NATIVE_OK and not records._GT_BATCH_OK
        # The self-check's 60 calls, then the output's, one per sample.
        assert per_sample.call_count > 60
    assert got == lines
