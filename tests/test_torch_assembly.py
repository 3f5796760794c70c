"""The port's local assembler (--assemble=1) on long insertions and
deletions that 150 bp reads carry as soft clips: its native tile loop
against the benchmark's plain assembler (portbench/reference/assembly.py)
tile by tile and against its own Python path, the whole run against the
JAX package byte for byte, the cycle check's k += 5 counted, the tiles'
reference slices, and the region pipeline's schedule under --assemble=1
(each region's assembly on the prefetch helper, started before the
previous region is prepared) against the one without it."""

import logging
import os
import threading

import pytest
import torch

from platypus_tpu_torch import native
from platypus_tpu_torch.candidates import assembly
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import region as region_mod
from platypus_tpu_torch.engine import runner
from platypus_tpu_torch.io.bam import BamFile
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
    kw.setdefault("buffer_size", 10_000)
    return PlatypusConfig(bam_files=[os.path.join(d, "S000.bam")],
                          ref_file=os.path.join(d, "ref.fa"), assemble=1,
                          **kw)


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


def _data_lines(path):
    with open(path) as fh:
        return [x for x in fh if not x.startswith("#")]


# Four 5 kb regions of the 20 kb contig: the first loads and assembles
# inline, the helper carries the other three.
QUARTERS = [(CONTIG, a, a + 5000) for a in range(0, 20_000, 5000)]


@pytest.fixture(scope="module")
def jax_quarters(long_events, tmp_path_factory):
    """The JAX package's CLI over the contig in 5 kb regions: its VCF data
    lines."""
    from platypus_tpu.cli import main as jax_cli

    d, _meta = long_events
    out = tmp_path_factory.mktemp("jax_quarters")
    want = str(out / "jax.vcf")
    assert jax_cli(["callVariants", f"--bamFiles={d}/S000.bam",
                    f"--refFile={d}/ref.fa", "--assemble=1",
                    "--bufferSize=5000", "--deviceInference=0",
                    f"--logFileName={out}/log.txt", "-o", want]) == 0
    return _data_lines(want)


class _Schedule:
    """What the pipeline did, in order: ("yield" | "prepare" | "prepared" |
    "done", region); and every BAM fetch made on the pipeline thread while
    a prefetch helper was alive."""

    def __init__(self, monkeypatch):
        self.events, self.bad_fetches, self.helpers = [], [], []
        self.pipeline = threading.current_thread()
        fetch, prepare = BamFile.fetch, runner.prepare_region_call
        helpers = self.helpers

        class Prefetch(region_mod.RegionPrefetch):
            def __init__(self, *args):
                super().__init__(*args)
                helpers.append(self._thread)

        def fetch_noted(bam, *args, **kw):
            if (threading.current_thread() is self.pipeline
                    and any(t.is_alive() for t in self.helpers)):
                self.bad_fetches.append(args[:3])
            return fetch(bam, *args, **kw)

        def prepare_noted(chrom, start, end, *args, **kw):
            self.events.append(("prepare", (chrom, start, end)))
            try:
                return prepare(chrom, start, end, *args, **kw)
            finally:
                self.events.append(("prepared", (chrom, start, end)))

        monkeypatch.setattr(runner, "RegionPrefetch", Prefetch)
        monkeypatch.setattr(BamFile, "fetch", fetch_noted)
        monkeypatch.setattr(runner, "prepare_region_call", prepare_noted)

    def source(self, regions):
        for region in regions:
            self.events.append(("yield", region))
            yield region

    def done(self, region) -> None:
        self.events.append(("done", region))

    def at(self, kind, region) -> int:
        return self.events.index((kind, region))

    def of(self, kind):
        return [r for k, r in self.events if k == kind]


def test_prefetched_assembly_matches_the_jax_package(long_events,
                                                     jax_quarters, tmp_path,
                                                     monkeypatch):
    """Four regions with --assemble=1 through run_single_process: the VCF
    data lines equal the JAX package's byte for byte; assembly_prefetched counts the three regions
    whose helper assembled them; the tiles and variants equal those of
    every region assembled inline."""
    d, _meta = long_events
    config = _config(d, device_inference=1, buffer_size=5000)
    GLOBAL_METRICS.reset()
    for _chrom, start, end in QUARTERS:
        buffers, ref = _buffers(config, start, end)
        assembly.assemble_region_variants(CONTIG, start, end, ref, buffers,
                                          config)
    inline = dict(GLOBAL_METRICS.counters)
    sched = _Schedule(monkeypatch)
    out = str(tmp_path / "port.vcf")
    GLOBAL_METRICS.reset()
    assert runner.get_regions(config) == QUARTERS
    runner.run_single_process(config, QUARTERS, out, torch.device("cpu"))
    assert _data_lines(out) == jax_quarters
    counters = GLOBAL_METRICS.counters
    assert len(sched.helpers) == len(QUARTERS) - 1
    assert not sched.bad_fetches
    assert counters["assembly_prefetched"] == len(QUARTERS) - 1
    for name in ("assembly_tiles", "assembly_variants"):
        assert counters[name] == inline[name] > 0, name
    assert GLOBAL_METRICS.timers["assembly"] > 0


@pytest.mark.parametrize("assemble", [0, 1])
def test_the_schedule_keeps_one_region_ahead(long_events, tmp_path,
                                             monkeypatch, assemble):
    """Every region the source yields is prepared and reaches
    on_region_done once, in order, and no BAM fetch runs on the pipeline
    thread while a helper is alive.  With --assemble=0 region k+1 is asked
    for only once prepare_region_call(k) has returned; with --assemble=1
    as soon as region k's helper is joined, before prepare(k) starts,
    and never before prepare(k-1) has returned."""
    d, _meta = long_events
    config = _config(d, buffer_size=5000)
    config.assemble = assemble
    sched = _Schedule(monkeypatch)
    runner.run_single_process(config, sched.source(QUARTERS),
                              str(tmp_path / "out.vcf"), torch.device("cpu"),
                              on_region_done=sched.done)
    assert sched.of("yield") == sched.of("prepare") == QUARTERS
    assert sched.of("done") == QUARTERS
    assert not sched.bad_fetches
    assert len(sched.helpers) == len(QUARTERS) - 1
    for k in range(1, len(QUARTERS)):
        nxt = sched.at("yield", QUARTERS[k])
        if assemble and k > 1:
            assert sched.at("prepared", QUARTERS[k - 2]) < nxt \
                < sched.at("prepare", QUARTERS[k - 1])
        else:
            assert sched.at("prepared", QUARTERS[k - 1]) < nxt


@pytest.mark.parametrize("failing", [0, 2])
def test_a_failed_assembly_skips_its_region_alone(long_events, tmp_path,
                                                  monkeypatch, caplog,
                                                  failing):
    """An assembler that raises in one region, the first (inline) or one a
    helper carries: that region is logged and skipped, reaches
    on_region_done once, and every other region's lines are written as
    without the fault."""
    d, _meta = long_events
    config = _config(d, buffer_size=5000)
    clean = str(tmp_path / "clean.vcf")
    runner.run_single_process(config, QUARTERS, clean, torch.device("cpu"))
    orig = assembly.assemble_region_variants
    bad = QUARTERS[failing]

    def failing_region(chrom, start, end, *args):
        if (chrom, start, end) == bad:
            raise ValueError("injected assembler fault")
        return orig(chrom, start, end, *args)

    monkeypatch.setattr(assembly, "assemble_region_variants", failing_region)
    sched = _Schedule(monkeypatch)
    out = str(tmp_path / "out.vcf")
    with caplog.at_level(logging.INFO, logger="platypus_tpu"):
        runner.run_single_process(config, sched.source(QUARTERS), out,
                                  torch.device("cpu"),
                                  on_region_done=sched.done)
    # a skipped region is done at once, ahead of the regions in flight
    assert sorted(sched.of("done")) == QUARTERS
    assert [r for r in sched.of("done") if r != bad] == \
        [r for r in QUARTERS if r != bad]
    faults = [r for r in caplog.records if r.exc_info
              and "injected assembler fault" in str(r.exc_info[1])]
    assert len(faults) == 1
    assert f"{bad[1]}-{bad[2]}" in faults[0].getMessage()
    kept = [x for x in _data_lines(clean)
            if not bad[1] < int(x.split("\t")[1]) <= bad[2]]
    assert len(kept) < len(_data_lines(clean))
    assert _data_lines(out) == kept


@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_tile_slices_equal_their_own_reads(long_events, where):
    """tile_sequences' slices of one read equal get_sequence tile by tile
    at the contig's start, middle and end (its clamps to 0 and to the
    length - 1 included), with the region cache set elsewhere and over
    the tiles alike."""
    d, _meta = long_events
    ref = FastaFile(os.path.join(d, "ref.fa"))
    length = ref.refs[CONTIG].length
    first = {"start": -1500, "middle": 8000, "end": length - 4000}[where]
    spans = [(a, a + 4500) for a in range(first, first + 6000, 750)]
    spans.append((length + 10, length + 4500))
    for cache in ((CONTIG, 0, 100), (CONTIG, first - 2000, first + 12_000)):
        ref.set_cache_sequence(*cache)
        want = [ref.get_sequence(CONTIG, a, b) for a, b in spans]
        assert assembly.tile_sequences(ref, CONTIG, spans) == want
    assert any(want) and want[-1] == b""
