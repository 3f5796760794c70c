"""The port's local assembler (--assemble=1) on long insertions and
deletions that 150 bp reads carry as soft clips: its native tile loop
against the benchmark's plain assembler (portbench/reference/assembly.py)
tile by tile and against its own Python path, the whole run against the
JAX package byte for byte, and the cycle check's k += 5 counted."""

import os

import pytest
import torch

from platypus_tpu_torch import native
from platypus_tpu_torch.candidates import assembly
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import region as region_mod
from platypus_tpu_torch.engine import runner
from platypus_tpu_torch.io.fasta import FastaFile
from platypus_tpu_torch.utils.observability import GLOBAL_METRICS

from portbench.harness import bamio
from portbench.reference import assembly as plain
from portbench.traffic import synth, synth_long

CONTIG = "synth1"
SEED = 2**33 + 161

CONFIG = {"contig": CONTIG, "genome_length": 20_000, "samples": 1,
          "read_length": 150, "base_quality": 35, "mapq": 60,
          "error_rate": 0.003, "platypus": {"buffer_size": 10_000}}
# wgs30x_long's model with the long events 2-3 kb apart, so that a 20 kb
# contig holds several
TRAFFIC = {"coverage": 30,
           "variants": {"genotype": "genome", "spacing": [400, 1000],
                        "snv": 0.88, "ins": 0.06, "del": 0.06,
                        "indel_length": [1, 7], "hom_share": 0.4},
           "long_events": {"spacing": [2000, 3000], "length": [20, 150],
                           "ins": 0.57, "margin": 50},
           "clipping": {"min_aligned": 20}}


@pytest.fixture(scope="module")
def long_events(tmp_path_factory):
    """A 20 kb contig with long events every 2-3 kb, 30x of 150 bp reads
    clipped as a local aligner clips them; returns (dir, meta)."""
    d = tmp_path_factory.mktemp("torch_assembly")
    meta = synth_long.build(str(d), CONFIG, TRAFFIC, SEED)
    return str(d), meta


def _config(d, **kw):
    return PlatypusConfig(bam_files=[os.path.join(d, "S000.bam")],
                          ref_file=os.path.join(d, "ref.fa"), assemble=1,
                          buffer_size=10_000, **kw)


def _buffers(config, start, end):
    bams, by_bam, _samples = runner.open_bams(config)
    return (region_mod.load_region_buffers(bams, by_bam, CONTIG, start, end,
                                           config),
            FastaFile(config.ref_file))


def _recorded(monkeypatch):
    """Calls of the native region assembler: (arguments, result)."""
    calls = []
    orig = native.native_assemble_region

    def recording(*args):
        out = orig(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(native, "native_assemble_region", recording)
    return calls


def test_native_tiles_equal_the_plain_assembler(long_events, monkeypatch):
    """Every tile of the contig's two regions: the native assembler's
    variants equal the plain assembler's as sorted lists, and the long
    events are among them."""
    d, meta = long_events
    calls = _recorded(monkeypatch)
    config = _config(d)
    found = set()
    for start in (0, 10_000):
        buffers, ref = _buffers(config, start, start + 10_000)
        for v in assembly.assemble_region_variants(CONTIG, start,
                                                   start + 10_000, ref,
                                                   buffers, config):
            found.add((v.ref_pos, len(v.removed), len(v.added)))
    tiles = 0
    for (tile_meta, piles, k, min_qual, min_weight, no_cycles, _threads,
         region_ref, slices), (per_tile, retries) in calls:
        for t, (ref_seq, ref_start, a, b, reads) in enumerate(
                plain.tile_inputs(tile_meta, piles, slices, region_ref)):
            want, _r = plain.assemble_tile(ref_seq, ref_start, a, b, reads,
                                           k, min_qual, min_weight, no_cycles)
            assert sorted(per_tile[t]) == want, (a, b)
            tiles += 1
    assert tiles == 2 * len(range(0, 10_000, 750))
    long_ = {(int(p), int(n), len(alt)) for p, n, alt in
             (key.split(":") for key in meta["long"])}
    assert long_ & found


def test_native_tile_loop_equals_the_python_path(long_events):
    """assemble_region_variants (one native call) against the Python
    graph (use_native=False) tile by tile, in the same order."""
    d, _meta = long_events
    config = _config(d)
    buffers, ref = _buffers(config, 0, 10_000)
    got = assembly.assemble_region_variants(CONTIG, 0, 10_000, ref, buffers,
                                            config)
    want = []
    for a in range(0, 10_000, 750):
        b = min(a + 1500, 10_000)
        ref_start = max(0, a - 1500)
        ref_seq = ref.get_sequence(CONTIG, ref_start, b + 1500)
        want.extend(assembly.assemble_reads_and_detect_variants(
            CONTIG, a, b, ref_start, ref_seq, buffers, config,
            use_native=False)[0])
    assert [(v.ref_pos, v.removed, v.added) for v in got] == \
        [(v.ref_pos, v.removed, v.added) for v in want]
    assert any(max(len(v.removed), len(v.added)) >= 20 for v in got)


def test_run_single_process_matches_the_jax_package(long_events, tmp_path):
    """The whole contig with --assemble=1 through the port's
    run_single_process (fused inference on the CPU) and through the JAX
    package's CLI (float64 host inference): VCF data lines byte-identical,
    long alleles among them."""
    from platypus_tpu.cli import main as jax_cli

    d, _meta = long_events
    config = _config(d, device_inference=1)
    out = str(tmp_path / "port.vcf")
    GLOBAL_METRICS.reset()
    runner.run_single_process(config, runner.get_regions(config), out,
                              torch.device("cpu"))
    want = str(tmp_path / "jax.vcf")
    assert jax_cli(["callVariants", f"--bamFiles={d}/S000.bam",
                    f"--refFile={d}/ref.fa", "--assemble=1",
                    "--bufferSize=10000", "--deviceInference=0",
                    f"--logFileName={tmp_path}/log.txt", "-o", want]) == 0

    def lines(path):
        with open(path) as fh:
            return [x for x in fh if not x.startswith("#")]

    port = lines(out)
    assert port == lines(want)
    assert any(max(len(c) for c in x.split("\t")[3:5]) > 20 for x in port)
    counters = GLOBAL_METRICS.counters
    assert counters["assembly_tiles"] == 2 * len(range(0, 10_000, 750))
    assert counters["assembly_variants"] > 0


def test_cycle_check_counts_its_retries(tmp_path, monkeypatch):
    """A reference whose 17 bp unit repeats back to back holds a cycle at
    k = 15 and none at k = 20: with --noCycles=1 each tile whose slice
    holds the repeat builds its graph once more, which
    assembly_kmer_retries counts; the plain assembler counts the same and
    finds the same variants.  Without --noCycles nothing is rebuilt."""
    rng = synth._rng(SEED, 7)
    ref = synth.ACGT[rng.integers(0, 4, 6000)]
    ref[3017:3034] = ref[3000:3017]
    bamio.write_fasta(str(tmp_path / "ref.fa"), CONTIG, ref)
    snv = b"A" if ref[1500] != ord("A") else b"C"
    haps = [synth.SimHaplotype(ref, [(1500, 1, snv)])] * 2
    pos, seq, special = synth.simulate_reads(
        haps, 0, 6000, 150, 30.0, synth._rng(SEED, 8), synth._rng(SEED, 9),
        0.0)
    bamio.write_bam(str(tmp_path / "S000.bam"), CONTIG, 6000, pos, seq,
                    special, 35, 60, "S000")
    config = _config(str(tmp_path), no_cycles=1)
    buffers, fasta = _buffers(config, 0, 6000)
    calls = _recorded(monkeypatch)
    GLOBAL_METRICS.reset()
    got = assembly.assemble_region_variants(CONTIG, 0, 6000, fasta, buffers,
                                            config)
    ((args, (per_tile, retries)),) = calls
    want_retries = 0
    for t, (ref_seq, ref_start, a, b, reads) in enumerate(
            plain.tile_inputs(args[0], args[1], args[8], args[7])):
        want, r = plain.assemble_tile(ref_seq, ref_start, a, b, reads,
                                      *args[2:6])
        assert sorted(per_tile[t]) == want
        want_retries += r
    assert retries == want_retries > 0
    assert GLOBAL_METRICS.counters["assembly_kmer_retries"] == retries
    assert any(v.ref_pos == 1500 and v.added == snv for v in got)
    GLOBAL_METRICS.reset()
    assembly.assemble_region_variants(CONTIG, 0, 6000, fasta, buffers,
                                      _config(str(tmp_path)))
    assert GLOBAL_METRICS.counters["assembly_kmer_retries"] == 0
