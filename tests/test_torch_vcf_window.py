"""The VCF output's window entry (platypus_tpu_torch/native/src/vcf_window.cpp
ptpu_vcf_window): one C++ call writes a called window's data lines.  Its
bytes are held to the Python route (vcfout/records._output_call_to_vcf_py),
which writes where the library does not load:

* on every window of port runs at 1, 3, 16 and 30 samples and on a 30x
  sample with indels and multi-allelic sites, under configurations that
  trip each FILTER alone and the GT rules of min_posterior and min_reads;
* on randomized windows around a short contig with N bases: SNPs, MNPs
  and replacements that need the left trim, insertions and deletions,
  several alleles at a position, positions at both contig ends, samples
  without reads, cohorts past 25 samples, PP values at "%.0f"'s ties, FR
  at "%1.4f"'s, QD over the cap and integral;
* on windows built so that GL, GQ, MQ and BRF land on round_ref's ties
  (ties away from zero at 0 and 2 digits), and QD and MQ on integral
  values ("%.12g" plus ".0").

HapScore's sums are a left fold over the rows in the window entry: numpy's
order for compute_haplotype_score's expression with two or more
haplotypes, pinned here bit for bit and on a window whose gap lands on 50
only in that order.  Where the Python route raises, output_call_to_vcf
raises the same error."""

import dataclasses
import io
import math
import os
import types

import numpy as np
import pytest

from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch import native
from platypus_tpu_torch.candidates.variant import (ASSEMBLER_VAR, FILE_VAR,
                                                   PLATYPUS_VAR, Variant)
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import region as region_mod
from platypus_tpu_torch.io.fasta import FastaFile, build_index
from platypus_tpu_torch.models.haplotype import Haplotype
from platypus_tpu_torch.ops.likelihood import genotype_index_pairs
from platypus_tpu_torch.utils.maths import round_ref
from platypus_tpu_torch.utils.observability import GLOBAL_METRICS
from platypus_tpu_torch.vcfout import records
from platypus_tpu_torch.vcfout.writer import VCFWriter
from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam
from test_torch_smoke_data import cohort_dataset
from test_torch_vcf_batch import _Cigars, _random_window

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="the port's native library did not build")

# Each FILTER tripped alone, the GT rules, and the paths around them; with
# whether the change moves some line of every run.
CONFIG_CHANGES = [
    ({}, False),
    ({"qd_threshold": 1e9}, True),
    ({"hap_score_threshold": 0}, True),
    ({"rmsmq_threshold": 1000}, True),
    ({"sb_threshold": 2.0}, True),
    ({"ab_threshold": 2.0}, True),
    ({"bad_reads_threshold": 1000}, True),
    ({"filtered_reads_frac": 0.0}, True),
    ({"sc_threshold": 0.0}, True),
    ({"min_posterior": 0}, False),
    ({"min_posterior": 60}, False),
    ({"min_posterior": 200}, True),
    ({"min_reads": 1000}, True),
    ({"output_ref_calls": 1, "min_posterior": 150}, True),
    ({"qd_threshold": 10.5}, False),
]


class _Buffer:
    def __init__(self, sample):
        self.sample = sample


def _both_routes(call, buffers, ref_file, config, samples):
    """(native text, Python text, lines each): the window through
    output_call_to_vcf with the library loaded and through the Python
    route, each into a writer of its own."""
    out = []
    for route in (records.output_call_to_vcf, records._output_call_to_vcf_py):
        fh = io.StringIO()
        writer = VCFWriter(fh, samples)
        n = route(call, buffers, ref_file, config, writer)
        writer.drain()
        out.append((fh.getvalue(), n))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _assert_same(call, buffers, ref_file, config, samples, label):
    before = GLOBAL_METRICS.counters.get("vcf_native_windows", 0)
    got, want, n_got, n_want = _both_routes(call, buffers, ref_file, config,
                                            samples)
    assert got == want, (label, got, want)
    assert n_got == n_want == want.count("\n"), label
    assert GLOBAL_METRICS.counters.get("vcf_native_windows", 0) == before + 1
    return want


# ---------------------------------------------------------------------------
# Windows of port runs
# ---------------------------------------------------------------------------

def _indel_dataset(workdir):
    """One 30x sample whose two haplotypes carry different alleles at the
    same positions: two SNVs, an insertion and a deletion, a deletion and a
    SNV, two insertions; single indels and SNVs beside them."""
    info_path = os.path.join(workdir, "reads.bam")
    ref_path, ref_seq = make_reference(workdir, length=24000, seed=11)
    if not os.path.exists(info_path):
        def snp(pos, base):
            return (pos, 1, base if ref_seq[pos] != base[0] else b"G")

        hap_a = [snp(3000, b"A"), (3030, 0, b"TTA"), (6100, 3, b""),
                 (9050, 0, b"TTA"), (12500, 2, b"")]
        hap_b = [snp(3000, b"C"), (3030, 2, b""), (6100, 1, b"C"),
                 (9050, 0, b"TT"), snp(12700, b"T")]
        reads = simulate_reads([SimHaplotype(ref_seq, hap_a),
                                SimHaplotype(ref_seq, hap_b)], 1000, 15000,
                               coverage=30, error_rate=0.002, seed=5,
                               fast_errors=True)
        write_synth_bam(workdir, reads, ref_len=24000)
    return dict(bam=info_path, ref=ref_path, region="chr20:1000-15000")


@pytest.fixture(scope="module")
def port_windows(tmp_path_factory):
    """dataset -> the windows a port run sent to the VCF output, each with
    its buffers, reference, configuration and output samples."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        workdir = str(tmp_path_factory.mktemp(f"vcf_window_{name}"))
        if name == "indels":
            info = _indel_dataset(workdir)
        else:
            info = cohort_dataset(workdir, int(name[len("cohort"):]), 6000, 6)
        windows = []
        inner = region_mod.output_call_to_vcf

        def capture(call, buffers, ref_file, config, writer):
            if call.variant_posteriors:
                windows.append((call, buffers, ref_file, config,
                                list(writer.samples)))
            return inner(call, buffers, ref_file, config, writer)

        out = os.path.join(workdir, "out.vcf")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(region_mod, "output_call_to_vcf", capture)
            rc = port_cli.main(["callVariants", f"--bamFiles={info['bam']}",
                                f"--refFile={info['ref']}",
                                f"--regions={info['region']}",
                                f"--logFileName={out}.log", "-o", out],
                               device="cpu")
        assert rc == 0 and windows
        built[name] = windows
        return windows

    return get


@pytest.mark.parametrize("name", ["cohort1", "cohort3", "cohort16",
                                  "cohort30", "indels"])
def test_port_windows_match_python_route(port_windows, name):
    """Every window of the run, under each configuration, gives the Python
    route's bytes; the runs hold multi-allelic positions and indels, and
    each configuration change moves some line."""
    windows = port_windows(name)
    texts = []
    for changes, _moves in CONFIG_CHANGES:
        lines = []
        for call, buffers, ref_file, config, samples in windows:
            lines.append(_assert_same(call, buffers, ref_file,
                                      dataclasses.replace(config, **changes),
                                      samples, (name, changes)))
        texts.append("".join(lines))
    for text, (changes, moves) in zip(texts, CONFIG_CHANGES):
        assert not moves or text != texts[0], (name, changes)
    if name == "indels":
        records_ = [line.split("\t") for line in texts[0].splitlines()]
        assert any("," in rec[4] for rec in records_)
        assert any(len(rec[3]) != len(alt) for rec in records_
                   for alt in rec[4].split(","))
    if name == "cohort30":
        assert len(windows[0][1]) == 30


# ---------------------------------------------------------------------------
# Randomized windows
# ---------------------------------------------------------------------------

def _contig(tmp_path, rng, length):
    """A FASTA of one contig, chr20, with a few N bases; a FastaFile."""
    seq = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), length))
    for p in rng.integers(0, length, 6):
        seq[int(p)] = ord("N")
    path = os.path.join(tmp_path, f"ref_{length}_{rng.integers(1 << 30)}.fa")
    with open(path, "wb") as fh:
        fh.write(b">chr20\n")
        for k in range(0, length, 60):
            fh.write(bytes(seq[k:k + 60]) + b"\n")
    build_index(path)
    return FastaFile(path), bytes(seq)


def _random_variants(rng, ref_seq, length):
    """Variants over [0, length): SNVs, MNPs whose first base is the
    reference's (left trim), replacements sharing a prefix, insertions and
    deletions, some at one position, some on N bases or at the ends."""
    out = []
    n_pos = int(rng.integers(1, 5))
    positions = set()
    for _ in range(n_pos):
        edge = rng.random()
        if edge < 0.15:
            pos = int(rng.integers(0, 12))
        elif edge < 0.3:
            pos = int(rng.integers(max(0, length - 14), length - 2))
        else:
            pos = int(rng.integers(12, length - 14))
        positions.add(pos)
    for pos in sorted(positions):
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(0, 6))
            base = ref_seq[pos:pos + 1]
            if kind == 0:    # SNV
                added = bytes([int(rng.choice(list(b"ACGT".replace(base, b""))))])
                removed = base
            elif kind == 1:  # MNP sharing the first base
                removed = ref_seq[pos:pos + 2]
                added = base + bytes([int(rng.choice(list(b"ACGT")))])
            elif kind == 2:  # replacement sharing a prefix
                removed = ref_seq[pos:pos + 2]
                added = base + bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                                int(rng.integers(2, 4))))
            elif kind == 3:  # insertion
                removed = b""
                added = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                         int(rng.integers(1, 4))))
            elif kind == 4:  # deletion
                removed = ref_seq[pos:pos + int(rng.integers(1, 5))]
                added = b""
            else:            # MNP
                removed = ref_seq[pos:pos + 3]
                added = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 3))
            if removed == added or not (removed or added):
                continue
            v = Variant("chr20", pos, removed, added,
                        var_source=int(rng.choice([PLATYPUS_VAR, ASSEMBLER_VAR,
                                                   PLATYPUS_VAR | ASSEMBLER_VAR,
                                                   FILE_VAR | PLATYPUS_VAR])))
            v.bam_min_pos = pos - int(rng.integers(0, 3))
            v.bam_max_pos = pos + max(0, len(removed) - 1) + int(rng.integers(0, 3))
            if v not in out:
                out.append(v)
    return out


def _random_call(rng, ref_file, ref_seq, n_ind, ties):
    """A WindowCall of random tables over _random_variants: haplotypes the
    reference, each variant alone and pairs of variants apart; the reads of
    test_torch_vcf_batch._random_window moved onto the contig."""
    length = len(ref_seq)
    variants = _random_variants(rng, ref_seq, length)
    reads, nsm, _specs, _vig = _random_window(rng, n_ind)
    nsm_idx, flat, off = nsm
    cigars = _Cigars(flat, off)
    reads.cigar_refs = [(cigars, int(j)) if j >= 0 else None for j in nsm_idx]
    reads.nsm_ctx = nsm
    shift = int(rng.integers(-60, max(-59, length - 460)))
    reads.pos = reads.pos + shift
    reads.end = reads.end + shift
    reads.qual = np.ascontiguousarray(reads.qual)
    R = len(reads.rlen)

    lo = max(0, min(v.ref_pos for v in variants) - 5)
    hi = min(length, max(v.max_ref_pos for v in variants) + 5)
    window = types.SimpleNamespace(start_pos=lo, end_pos=hi, chromosome="chr20",
                                   variants=list(variants))
    haps = [Haplotype("chr20", lo, hi, (), ref_file, 100)]
    haps += [Haplotype("chr20", lo, hi, (v,), ref_file, 100) for v in variants]
    for _ in range(int(rng.integers(0, 3))):
        a, b = sorted(rng.choice(len(variants), 2)) if len(variants) > 1 else (0, 0)
        va, vb = variants[a], variants[b]
        if va.max_ref_pos + 2 < vb.ref_pos:
            haps.append(Haplotype("chr20", lo, hi, (va, vb), ref_file, 100))
    H = len(haps)
    h1, h2 = genotype_index_pairs(H)
    G = len(h1)
    called = [v for v in variants if rng.random() < 0.85] or variants[:1]
    posteriors = {}
    for v in called:
        x = rng.random()
        if x < 0.2:
            posteriors[v] = float(rng.integers(5, 200)) + 0.5   # "%.0f" ties
        elif x < 0.3:
            posteriors[v] = float(rng.uniform(2500, 4000))      # QD's cap
        else:
            posteriors[v] = float(rng.uniform(0, 2500))
        v._prior = float(rng.choice([1e-3 / 3, 5e-5, 1e-10, 0.1]))
    vars_by_pos = {}
    for v in sorted(called, key=lambda v: v.ref_pos):
        vars_by_pos.setdefault(v.ref_pos, []).append(v)
    freqs = rng.random(H)
    if ties:
        freqs[rng.random(H) < 0.5] = 1 / 32                       # "%1.4f" ties
    n_reads = rng.integers(0, 30, n_ind).astype(np.int64)
    n_reads[rng.random(n_ind) < 0.2] = 0
    likelihoods = np.maximum(1e-300, rng.random((n_ind, G)))
    likelihoods[rng.random((n_ind, G)) < 0.2] = 1e-300
    gof = rng.uniform(0, 150, (G, n_ind))
    if ties:
        gof[rng.random((G, n_ind)) < 0.3] = 99.125
    return types.SimpleNamespace(
        window=window, haplotypes=haps, hap1_idx=h1, hap2_idx=h2,
        frequencies=freqs, likelihoods=likelihoods, gof=gof, n_reads=n_reads,
        genotype_calls=[int(rng.integers(0, G)) if rng.random() < 0.8 else None
                        for _ in range(n_ind)],
        variant_posteriors=posteriors, vars_by_pos=vars_by_pos, reads=reads,
        loglik=rng.uniform(-300, 0, (H, R)),
        hap_var_sets=[set(h.variants) for h in haps])


def _random_config(rng):
    return PlatypusConfig(
        min_posterior=int(rng.choice([0, 5, 20, 50])),
        min_reads=int(rng.choice([0, 2, 10])),
        output_ref_calls=int(rng.random() < 0.2),
        qd_threshold=float(rng.choice([10, 10.5, 30])),
        sc_threshold=float(rng.choice([0.95, 0.6, 0.5])),
        hap_score_threshold=int(rng.choice([1, 4, 10])),
        ab_threshold=float(rng.choice([1e-3, 0.5, 1.1])),
        sb_threshold=float(rng.choice([1e-3, 0.5, 1.1])),
        rmsmq_threshold=int(rng.choice([20, 40, 70])),
        bad_reads_threshold=int(rng.choice([15, 30, 40])),
        filtered_reads_frac=float(rng.choice([0.7, 0.2, 0.0])),
        count_only_exact_indel_matches=int(rng.random() < 0.5),
        bad_reads_window=int(rng.choice([1, 11, 15])))


@pytest.mark.parametrize("n_ind", [1, 3, 16, 30])
def test_random_windows_match_python_route(tmp_path, n_ind):
    rng = np.random.default_rng(1900 + n_ind)
    seen = dict(lines=0, trimmed=0, skipped=0, multi=0)
    for trial in range(40):
        ref_file, ref_seq = _contig(str(tmp_path), rng,
                                    int(rng.choice([60, 400, 2000])))
        call = _random_call(rng, ref_file, ref_seq, n_ind, ties=trial % 2 == 1)
        samples = [f"S{i}" for i in range(n_ind)]
        buffers = [_Buffer(s) for s in samples]
        if trial % 5 == 4:  # columns in another order than the buffers
            samples = samples[::-1]
        text = _assert_same(call, buffers, ref_file, _random_config(rng),
                            samples, trial)
        seen["lines"] += text.count("\n")
        written = {int(line.split("\t")[1]) - 1 for line in text.splitlines()}
        seen["trimmed"] += len(written - set(call.vars_by_pos))
        seen["multi"] += sum(len(v) > 1 for v in call.vars_by_pos.values())
        seen["skipped"] += sum(ref_seq[p:p + 1] == b"N" for p in call.vars_by_pos)
    assert min(seen.values()) > 0, seen


# ---------------------------------------------------------------------------
# round_ref's ties and integral values
# ---------------------------------------------------------------------------

def _is_tie(x, ndigits):
    s = math.ldexp(x, ndigits + 1)
    return s == int(s) and int(s) % 2 == 1


def _find(targets, inverse, value_of, ndigits, steps=4000):
    """A double x near inverse(t), for the first target t where one
    exists, whose value_of(x) is an exact tie at ndigits."""
    for t in targets:
        centre = inverse(t)
        up = down = centre
        for _ in range(steps):
            for x in (up, down):
                if _is_tie(value_of(x), ndigits):
                    return x
            up = math.nextafter(up, math.inf)
            down = math.nextafter(down, -math.inf)
    raise AssertionError("no tie found")


def _tie_call(ref_file, ref_seq, gl_ratio, gq_b):
    """One sample, one SNV at 30 whose haplotypes are the reference and
    the SNV: 64 reads over it, 8 of them bad (BRF 1/8), MAPQ 0 but one 1
    (MQ sqrt(1/64)); the marginals of the sample's classes are
    (1, gl_ratio, 1) at the first position's GL, and (1, gq_b, 1e-300) at
    the second's (GQ).  Prior 0.1 with PP 50 and 6 variant reads puts QD on
    10.0."""
    pos, pos2 = 30, 90
    snv = Variant("chr20", pos, ref_seq[pos:pos + 1],
                  b"A" if ref_seq[pos:pos + 1] != b"A" else b"C")
    snv2 = Variant("chr20", pos2, ref_seq[pos2:pos2 + 1],
                   b"A" if ref_seq[pos2:pos2 + 1] != b"A" else b"C")
    R, L = 64, 100
    seq = np.frombuffer(ref_seq[0:L], np.uint8)[None, :].repeat(R, 0).copy()
    seq[:6, pos] = snv.added[0]
    seq[:6, pos2] = snv2.added[0]
    mapq = np.zeros(R, np.int32)
    mapq[10] = 1
    is_good = np.ones(R, bool)
    is_good[-8:] = False
    reads = types.SimpleNamespace(
        seq=seq, qual=np.full((R, L), 35, np.uint8), rlen=np.full(R, L, np.int32),
        pos=np.zeros(R, np.int64), end=np.full(R, L, np.int64), mapq=mapq,
        strand_reverse=np.arange(R) % 2 == 0, sample_idx=np.zeros(R, np.int32),
        is_good=is_good, is_broken=np.zeros(R, bool),
        cigar_refs=[None] * R, nsm_ctx=None)
    reads.single_m = lambda: np.ones(R, bool)
    haps = [Haplotype("chr20", 20, 100, (), ref_file, 100),
            Haplotype("chr20", 20, 100, (snv, snv2), ref_file, 100)]
    h1, h2 = genotype_index_pairs(2)
    for v in (snv, snv2):
        v._prior = 0.1
    likelihoods = np.array([[1.0, gl_ratio / 2, 1.0]])
    call = types.SimpleNamespace(
        window=types.SimpleNamespace(start_pos=20, end_pos=100,
                                     chromosome="chr20", variants=[snv, snv2]),
        haplotypes=haps, hap1_idx=h1, hap2_idx=h2,
        frequencies=np.array([0.5, 0.5]), likelihoods=likelihoods,
        gof=np.full((3, 1), 3.0), n_reads=np.array([56]),
        genotype_calls=[1], variant_posteriors={snv: 50.0, snv2: 50.0},
        vars_by_pos={pos: [snv], pos2: [snv2]}, reads=reads,
        loglik=np.zeros((2, R)), hap_var_sets=[set(), {snv, snv2}])
    return call, likelihoods, gq_b


def test_rounding_ties_and_integral_values_match_python_route(tmp_path):
    rng = np.random.default_rng(7)
    ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    while b"N" in ref_seq[20:101]:
        ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    # GL = round_ref(log10(r), 2) on a tie; GQ = round_ref(-10 log10(1 -
    # post), 0) on a tie, post = b / (1 + b + 1e-300) of classes (1, b, ~0)
    # (a step of b moves the phred by a few ulps: some targets have no tie).
    gl_ratio = _find([-1.125, -1.375, -0.875, -0.625], lambda t: 10 ** t,
                     math.log10, 2)
    gq_b = _find([k + 0.5 for k in range(3, 30)], lambda t: 10 ** (t / 10) - 1,
                 lambda b: -10.0 * math.log10(
                     max(1e-10, 1.0 - b / (((0.0 + 1.0) + b) + 1e-300))), 0)
    call, likelihoods, _ = _tie_call(ref_file, ref_seq, gl_ratio, gq_b)
    config = PlatypusConfig(min_posterior=0)
    buffers, samples = [_Buffer("S0")], ["S0"]
    text = _assert_same(call, buffers, ref_file, config, samples, "gl tie")
    first = text.splitlines()[0].split("\t")
    info = dict(kv.split("=") for kv in first[7].split(";"))
    assert info["BRF"] == "0.13" and info["MQ"] == "0.13"
    assert info["QD"] == "10.0"
    gls = first[9].split(":")[1].split(",")
    assert _is_tie(math.log10(gl_ratio), 2)
    want_gl = round_ref(math.log10(gl_ratio), 2)
    assert gls[1] == repr(want_gl)
    assert abs(want_gl) > abs(math.log10(gl_ratio))  # away from zero
    # The GQ tie: the second position's classes (1, gq_b, 1e-300).
    likelihoods[0] = [1.0, gq_b / 2, 1e-300]
    text = _assert_same(call, buffers, ref_file, config, samples, "gq tie")
    second = text.splitlines()[1].split("\t")
    want = -10.0 * math.log10(max(1e-10, 1.0 - gq_b / (((0.0 + 1.0) + gq_b)
                                                     + 1e-300)))
    assert _is_tie(want, 0)
    assert second[9].split(":")[3] == str(int(round_ref(want)))


@pytest.mark.parametrize("H", [2, 3, 7])
def test_haplotype_sums_are_numpys_left_fold(H):
    """compute_haplotype_score's (LOG10E * loglik[:, rows]).sum(axis=1)
    with two or more haplotypes sums each row as a left fold (numpy keeps
    the haplotypes in its inner loop), which ptpu_vcf_window reproduces."""
    rng = np.random.default_rng(40 + H)
    for _trial in range(150):
        R = int(rng.integers(1, 900))
        loglik = rng.uniform(-60, 0, (H, R + 7))
        rows = np.sort(rng.choice(R + 7, R, replace=False))
        want = (records.LOG10E * loglik[:, rows]).sum(axis=1)
        for h in range(H):
            fold = 0.0
            for x in loglik[h, rows].tolist():
                fold += records.LOG10E * x
            assert np.float64(fold).tobytes() == want[h].tobytes()


def test_haplotype_score_gap_on_50_matches_python_route(tmp_path):
    """Two haplotypes whose sums lie exactly 50 apart in a left fold and
    under 50 in a pairwise sum: HapScore 1 on both routes, where a
    pairwise sum would have written 2."""
    rng = np.random.default_rng(9)
    ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    while b"N" in ref_seq[20:101]:
        ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    call, _likelihoods, _ = _tie_call(ref_file, ref_seq, 0.5, 1.0)
    R = call.loglik.shape[1]
    while True:
        row = rng.uniform(-3, -0.5, R)
        fold = 0.0
        for x in row[:-1].tolist():
            fold += records.LOG10E * x
        x = (-50.0 - fold) / records.LOG10E
        for _ in range(64):
            if fold + records.LOG10E * x == -50.0:
                break
            x = math.nextafter(x, -math.inf if fold + records.LOG10E * x > -50.0
                               else math.inf)
        row[-1] = x
        prod = records.LOG10E * row
        if (fold + prod[-1] == -50.0 and x < 0
                and float(np.sum(prod)) > -50.0):
            break
    call.loglik = np.stack([np.zeros(R), row])
    buffers, samples = [_Buffer("S0")], ["S0"]
    text = _assert_same(call, buffers, ref_file, PlatypusConfig(min_posterior=0),
                        samples, "gap 50")
    for line in text.splitlines():
        assert ";HapScore=1;" in line
    assert records.compute_haplotype_score(call) == 1


def test_python_route_errors_reach_the_caller(tmp_path):
    """A sample whose marginals are all zero makes the Python route divide
    by zero; the window entry leaves the window to it, and the error
    reaches the caller as before, with no window counted."""
    rng = np.random.default_rng(8)
    ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    while b"N" in ref_seq[20:101]:
        ref_file, ref_seq = _contig(str(tmp_path), rng, 400)
    call, likelihoods, _ = _tie_call(ref_file, ref_seq, 0.5, 1.0)
    likelihoods[0] = 0.0
    before = GLOBAL_METRICS.counters.get("vcf_native_windows", 0)
    for route in (records.output_call_to_vcf, records._output_call_to_vcf_py):
        with pytest.raises(ZeroDivisionError):
            route(call, [_Buffer("S0")], ref_file, PlatypusConfig(),
                  VCFWriter(io.StringIO(), ["S0"]))
    assert GLOBAL_METRICS.counters.get("vcf_native_windows", 0) == before
