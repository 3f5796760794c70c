"""The paired-end genome of the benchmark cell wgs1_30x_pe: its generator
(portbench/traffic/synth_pe.py) is byte-stable per seed and draws the
traffic file's shares; the port's read-pair QC equals the plain one
(portbench/reference/read_qc.py) read by read; its beam search equals the
plain one (portbench/reference/beam.py) window by window; its QC, trim and
beam counters equal the plain tallies; and its VCF data lines equal the
JAX package's.  The CPU tests run a 200 kb slice of the traffic at 20x and
a window of one long homopolymer whose eight haplotypes carry eight
lengths (the beam search's input: the slice's stutter brings fewer).
Each check has a card arm (-m cuda, `python -m pytest --noconftest`) on
the cell's own full-size dataset; there the JAX package does not run, so
the card's VCF lines are held to the port's host path, which the CPU
tests hold to the JAX package."""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import pytest
import torch

from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import caller, runner
from platypus_tpu_torch.io import readbuffer
from platypus_tpu_torch.io.bam import BamFile
from platypus_tpu_torch.utils.observability import GLOBAL_METRICS

from portbench.harness import bamio
from portbench.harness.core import HERE, load_json
from portbench.reference import beam as plain_beam
from portbench.reference import read_qc as plain_qc
from portbench.traffic import synth as pb_synth
from portbench.traffic import synth_pe

ROOT = os.path.dirname(HERE)
CELL = "wgs1_30x_pe"
CONTIG = "synth1"
SEED = 2**33 + 2101
CPU = torch.device("cpu")


def _small(length=200_000, coverage=20):
    cfg = load_json(HERE, "configs", "wgs1pe.json")
    cfg["genome_length"] = length
    tr = load_json(HERE, "traffic", "wgs30x_pe.json")
    tr["coverage"] = coverage
    return cfg, tr


@pytest.fixture(scope="module")
def pe_slice(tmp_path_factory):
    """The traffic over 200 kb at 20x: (dir, meta, traffic)."""
    d = tmp_path_factory.mktemp("wgs1pe_slice")
    cfg, tr = _small()
    return str(d), synth_pe.build(str(d), cfg, tr, SEED), tr


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """8 kb holding a 40 bp poly-A tract; eight haplotypes carry it at -3 to
    +4 bases (the odd ones with a SNV 60 bp on), 30x of 150 bp reads drawn
    from them in turn: one window of seven indels and a SNV, which the
    caller hands to the beam search.  Returns (dir, meta)."""
    d = str(tmp_path_factory.mktemp("wgs1pe_dense"))
    rng = pb_synth._rng(SEED, 40)
    ref = pb_synth.ACGT[rng.integers(0, 4, 8000)]
    ref[3000:3040] = ord("A")
    ref[2999], ref[3040] = ord("C"), ord("G")
    snv = [(3100, 1, b"T" if ref[3100] != ord("T") else b"G")]

    def allele(n):
        if n > 0:
            return [(3000, 0, b"A" * n)]
        return [(3000, -n, b"")] if n < 0 else []

    haps = [pb_synth.SimHaplotype(ref, allele(n) + (snv if n % 2 else []))
            for n in (-3, -2, -1, 0, 1, 2, 3, 4)]
    pos, seq, special = pb_synth.simulate_reads(
        haps, 0, 8000, 150, 30.0, pb_synth._rng(SEED, 41),
        pb_synth._rng(SEED, 42), 0.003)
    bamio.write_fasta(os.path.join(d, "ref.fa"), CONTIG, ref)
    bamio.write_bam(os.path.join(d, "S000.bam"), CONTIG, 8000, pos, seq,
                    special, 35, 60, "S000")
    return d, dict(bams=["S000.bam"], ref="ref.fa",
                   regions=[[CONTIG, 0, 8000]])


def _config(d, meta, **kw):
    return PlatypusConfig(bam_files=[os.path.join(d, b) for b in meta["bams"]],
                          ref_file=os.path.join(d, meta["ref"]),
                          buffer_size=100_000, **kw)


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d))}


def test_generator_is_byte_stable_per_seed(tmp_path):
    cfg, tr = _small(length=60_000, coverage=10)
    seen = []
    for k, seed in enumerate((SEED, SEED, SEED + 1)):
        d = tmp_path / f"d{k}"
        d.mkdir()
        synth_pe.build(str(d), cfg, tr, seed)
        seen.append(_digests(str(d)))
    assert seen[0] == seen[1]
    assert seen[0]["S000.bam"] != seen[2]["S000.bam"]


# -- the generator's shares ------------------------------------------------

def _within(got, n, p, sigmas=5.0):
    """got of n draws against share p: within `sigmas` binomial sds."""
    return abs(got / n - p) <= sigmas * math.sqrt(p * (1 - p) / n) + 1 / n


def _fragment_share(x, pairs):
    """P(fragment < x) under the traffic's fragment model."""
    mean, sd, ts = pairs["fragment_mean"], pairs["fragment_sd"], pairs["tail_share"]
    lo, hi = pairs["tail"]
    normal = 0.5 * (1 + math.erf((x - 0.5 - mean) / (sd * math.sqrt(2))))
    return (1 - ts) * normal + ts * min(1.0, max(0, x - lo) / (hi - lo + 1))


def check_shares(d, meta, traffic):
    """The BAM's records against the traffic file's shares and the
    generator's own tally of what it drew (meta["drawn"])."""
    pairs = traffic["pairs"]
    data = plain_qc.read_bam(os.path.join(d, meta["bams"][0]))
    recs = plain_qc.decode_bam(data, 0, 1 << 40)
    flags = np.array([r["flag"] for r in recs])
    tlen = np.array([r["tlen"] for r in recs])
    assert len(recs) == sum(meta["reads_per_region"])
    first = (flags & 0x400) == 0
    n_pairs = int(first.sum()) // 2
    drawn = meta["drawn"][0]
    assert n_pairs == drawn["fragments"]
    dup = int(((flags & 0x400) != 0).sum()) // 2
    unmapped = int(((flags & 0x4) != 0)[first].sum())
    improper = int(((flags & 0x40) != 0)[first & ((flags & 0xE) == 0)].sum())
    leftmost = first & ((flags & 0x2) != 0) & (tlen > 0)
    under_300 = int((tlen[leftmost] < 300).sum())
    under_150 = int((tlen[leftmost] < 150).sum())
    assert (dup, unmapped, improper) == (drawn["duplicated"],
                                         drawn["unmapped_mate"],
                                         drawn["improper"])
    normal = 1 - pairs["improper_share"] - pairs["unmapped_mate_share"]
    assert _within(dup, n_pairs, pairs["duplicate_share"] * normal)
    assert _within(unmapped, n_pairs, pairs["unmapped_mate_share"])
    assert _within(improper, n_pairs, pairs["improper_share"])
    n_left = int(leftmost.sum())
    assert _within(under_300, n_left, _fragment_share(300, pairs))
    assert _within(under_150, n_left, _fragment_share(150, pairs))
    assert under_150 > 0
    # STR tracts: spacing, periods and lengths of the traffic's "str"
    spec = traffic["str"]
    starts = np.array([s for s, _p, _n in meta["str"]])
    gaps = np.diff(starts)
    lo, hi = spec["spacing"]
    assert gaps.min() >= lo and gaps.max() <= hi
    sd = (hi - lo + 1) / math.sqrt(12) / math.sqrt(len(gaps))
    assert abs(gaps.mean() - (lo + hi) / 2) < 5 * sd
    assert {p for _s, p, _n in meta["str"]} == set(range(spec["period"][0],
                                                         spec["period"][1] + 1))
    with open(os.path.join(d, meta["ref"]), "rb") as fh:
        fh.readline()
        ref = fh.read().replace(b"\n", b"")
    for s, p, n in meta["str"]:
        assert spec["length"][0] <= n <= spec["length"][1]
        tract = ref[s:s + n]
        assert tract == (tract[:p] * (n // p + 1))[:n]
    assert drawn["stutter"] > 0 and drawn["homopolymer"] > 0


def test_generator_draws_the_traffic_shares(pe_slice):
    d, meta, tr = pe_slice
    check_shares(d, meta, tr)


# -- read-pair QC ------------------------------------------------------------

def check_read_qc(d, meta, regions):
    """Every read of each region: the port's verdict (good / bad / failed)
    and its quality bytes after the trims equal the plain QC's; so do the
    filters' counts and the trims' tallies.  Returns the summed counts."""
    data = plain_qc.read_bam(os.path.join(d, meta["bams"][0]))
    bam = BamFile(os.path.join(d, meta["bams"][0]))
    opts = readbuffer.QCOptions()
    totals = dict.fromkeys(plain_qc.FILTERS, 0)
    trims = {"overlap": 0, "adapter": 0}
    for chrom, a, b in regions:
        rs = bam.fetch(chrom, a, b)
        good, counts = readbuffer.check_and_trim_reads(rs, opts)
        recs = plain_qc.decode_bam(data, a, b)
        want, want_counts = plain_qc.check_and_trim(recs)
        assert len(rs) == len(recs)
        verdict = np.where(good, "good", np.where(rs.qc_fail, "qcfail", "bad"))
        assert [v for v, _q in want] == verdict.tolist()
        assert [q for _v, q in want] == [bytes(rs.qual[i, :rs.rlen[i]])
                                         for i in range(len(rs))]
        assert counts == want_counts
        tallies = plain_qc.trim_tallies(recs, want)
        assert readbuffer.trim_counts(rs, good, opts) == tallies
        for k in totals:
            totals[k] += counts[k]
        for k in trims:
            trims[k] += tallies[k]
    bam.close()
    return totals, trims


def test_read_qc_equals_the_plain_one(pe_slice):
    d, meta, _tr = pe_slice
    totals, trims = check_read_qc(d, meta, meta["regions"])
    for name in ("mate_unmapped", "mate_distant", "small_insert", "duplicate"):
        assert totals[name] > 0, name
    # every record under the adapter trim's condition is a small insert
    assert trims["overlap"] > 0 and trims["adapter"] == 0


# -- the beam search and the counters ---------------------------------------

class BeamRecorder:
    """The beam search's windows through run_single_process: its inputs
    and the haplotypes it kept."""

    def __init__(self, monkeypatch):
        self.windows = []
        orig = caller._beam_search_haplotypes

        def recording(window, variants, ref_hap, buffers, reads, ref_file,
                      config, rt, device):
            out = orig(window, variants, ref_hap, buffers, reads, ref_file,
                       config, rt, device)
            self.windows.append((window.start_pos, window.end_pos,
                                 list(variants), reads, rt.rlen, out))
            return out

        monkeypatch.setattr(caller, "_beam_search_haplotypes", recording)

    def check(self, ref: bytes, device="cpu"):
        """Each window's kept haplotypes against the plain search; the
        rounds and haplotypes it scored."""
        tally = {"rounds": 0, "candidates": 0}
        for start, end, variants, reads, rlen, out in self.windows:
            cols = dict(seq=reads.seq, qual=reads.qual, rlen=reads.rlen,
                        pos=reads.pos, end=reads.end, mapq=reads.mapq,
                        good=reads.is_good, sample=reads.sample_idx)
            want = plain_beam.haplotype_sets(
                (start, end), [(v.ref_pos, v.removed, v.added,
                                v.n_supporting_reads) for v in variants],
                cols, ref, rlen, device=device, tally=tally)
            got = [tuple(variants.index(v) for v in h.variants) for h in out]
            assert got == want, (start, end)
        return tally


def _reference(d, meta):
    with open(os.path.join(d, meta["ref"]), "rb") as fh:
        fh.readline()
        return fh.read().replace(b"\n", b"")


def run_and_check(d, meta, regions, device, monkeypatch, tmp_path,
                  plain_device="cpu"):
    """The regions through run_single_process on `device`: every beam
    window equal to the plain search, and the counters equal to the plain
    tallies (QC, trims, beam rounds and candidates).  Returns (beam
    windows, windows, the VCF path)."""
    rec = BeamRecorder(monkeypatch)
    config = _config(d, meta, device_inference=1)
    out = str(tmp_path / "port.vcf")
    GLOBAL_METRICS.reset()
    runner.run_single_process(config, [tuple(r) for r in regions], out,
                              device)
    c = dict(GLOBAL_METRICS.counters)
    tally = rec.check(_reference(d, meta), plain_device)
    assert c["beam_windows"] == len(rec.windows)
    assert c.get("beam_rounds", 0) == tally["rounds"] == sum(
        len(w[2]) for w in rec.windows)
    assert c.get("beam_candidates", 0) == tally["candidates"]
    assert ("beam_search" in GLOBAL_METRICS.timers) == bool(rec.windows)
    totals, trims = check_read_qc(d, meta, regions)
    for name, n in totals.items():
        assert c["reads_filtered." + name] == n, name
    assert c["reads_trimmed_overlap"] == trims["overlap"]
    assert c["reads_trimmed_adapter"] == trims["adapter"]
    return len(rec.windows), c["windows"], out


@pytest.mark.parametrize("device", [None, CPU], ids=["host", "torch_cpu"])
def test_beam_search_and_counters_equal_the_plain_ones(dense, device,
                                                       monkeypatch, tmp_path):
    d, meta = dense
    n_beam, _windows, _out = run_and_check(d, meta, meta["regions"], device,
                                           monkeypatch, tmp_path)
    assert n_beam == 1


def test_slice_counters_equal_the_plain_tallies(pe_slice, monkeypatch,
                                                tmp_path):
    d, meta, _tr = pe_slice
    run_and_check(d, meta, meta["regions"], CPU, monkeypatch, tmp_path)


def test_readers_read_the_counters_and_nothing_without_them():
    """The cell's three readers: None on a program without the counters
    (the parent's), their ratios on one with them."""
    from portbench.harness.core import Context
    from portbench.metrics import (beam_search_s_per_mreads,
                                   beam_window_share, pair_filtered_share)

    def ctx(timers):
        return Context(10.0, 2_000_000, [], 1.0, timers, None, None, None)

    readers = (beam_search_s_per_mreads, beam_window_share,
               pair_filtered_share)
    GLOBAL_METRICS.reset()
    assert [m.read(ctx({})) for m in readers] == [None, None, None]
    for name, n in (("windows", 400), ("beam_windows", 0), ("reads", 1000),
                    ("reads_filtered.mate_unmapped", 5),
                    ("reads_filtered.mate_distant", 10),
                    ("reads_filtered.small_insert", 7),
                    ("reads_filtered.duplicate", 38),
                    ("reads_filtered.low_map_qual", 100)):
        GLOBAL_METRICS.count(name, n)
    assert [m.read(ctx({})) for m in readers] == [0.0, 0.0, 6.0]
    GLOBAL_METRICS.count("beam_windows", 4)
    assert beam_window_share.read(ctx({})) == 1.0
    assert beam_search_s_per_mreads.read(ctx({"beam_search": 3.0})) == 1.5
    GLOBAL_METRICS.reset()


# -- the VCF against the JAX package -------------------------------------------

def _data_lines(path):
    with open(path) as fh:
        return [x for x in fh if not x.startswith("#")]


@pytest.mark.parametrize("which", ["slice", "dense"])
def test_vcf_lines_equal_the_jax_package(which, pe_slice, dense, tmp_path):
    """The port's run_single_process (fused inference on the CPU) and the
    JAX package's CLI (float64 host inference) over the whole data set:
    data lines byte-identical."""
    from platypus_tpu.cli import main as jax_cli

    d, meta = (pe_slice[0], pe_slice[1]) if which == "slice" else dense
    config = _config(d, meta, device_inference=1)
    out = str(tmp_path / "port.vcf")
    runner.run_single_process(config, runner.get_regions(config), out, CPU)
    want = str(tmp_path / "jax.vcf")
    assert jax_cli(["callVariants",
                    f"--bamFiles={os.path.join(d, meta['bams'][0])}",
                    f"--refFile={os.path.join(d, meta['ref'])}",
                    "--bufferSize=100000", "--deviceInference=0",
                    f"--logFileName={tmp_path}/log.txt", "-o", want]) == 0
    port = _data_lines(out)
    assert port and port == _data_lines(want)


# -- card arms: the cell's own full-size dataset ------------------------------

@pytest.fixture(scope="module")
def cell_data():
    """The cell's dataset for one seed, built as the benchmark builds it:
    (dir, meta, traffic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness.core import dataset, load_cell

    cell = load_cell(ROOT, CELL, False)
    d, meta, _s = dataset(cell, 2**31 + 2101)
    return d, meta, cell.traffic


def _spread(meta, n):
    regions = meta["regions"]
    return [regions[int(k)] for k in np.linspace(0, len(regions) - 1, n)]


@pytest.mark.cuda
def test_card_generator_shares_on_the_cell(cell_data):
    check_shares(*cell_data)


@pytest.mark.cuda
def test_card_read_qc_on_the_cell(cell_data):
    d, meta, _tr = cell_data
    check_read_qc(d, meta, _spread(meta, 12))


@pytest.mark.cuda
def test_card_beam_search_and_counters_on_the_cell(cell_data, dense,
                                                   monkeypatch, tmp_path):
    """Twelve regions of the cell and the dense window on the card: every
    beam window equal to the plain search (its DP on the card), the
    counters to the plain tallies; prints the cell's beam windows."""
    card = torch.device("cuda", 0)
    d, meta, _tr = cell_data
    n_beam, windows, _out = run_and_check(d, meta, _spread(meta, 12), card,
                                          monkeypatch, tmp_path, card)
    print(f"cell: {n_beam} beam windows of {windows}")
    d, meta = dense
    n_beam, _w, _out = run_and_check(d, meta, meta["regions"], card,
                                     monkeypatch, tmp_path, card)
    assert n_beam == 1


@pytest.mark.cuda
def test_card_vcf_lines_equal_the_host_path(cell_data, tmp_path):
    """Three regions of the cell on the card and on the port's host path
    (native alignment, float64 inference): data lines byte-identical."""
    d, meta, _tr = cell_data
    regions = [tuple(r) for r in _spread(meta, 3)]
    lines = []
    for name, device in (("card", torch.device("cuda", 0)), ("host", None)):
        out = str(tmp_path / f"{name}.vcf")
        runner.run_single_process(_config(d, meta), regions, out, device)
        lines.append(_data_lines(out))
    assert lines[0] and lines[0] == lines[1]
