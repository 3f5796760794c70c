"""The torch port's span tree (utils/observability.Metrics.timer): nesting,
self times, helper threads, the profiler annotations, the spans of one
region through run_single_process, K3's window and EM-iteration counters,
and the benchmark's readers of the spans and counters."""

import json
import os
import threading
import time

import pytest
import torch

from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import runner
from platypus_tpu_torch.ops import likelihood_cuda
from platypus_tpu_torch.parallel import batch
from platypus_tpu_torch.utils import observability
from platypus_tpu_torch.utils.observability import GLOBAL_METRICS, Metrics
from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

CPU = torch.device("cpu")
REGION = ("chr20", 1000, 8500)
# Each existing timer and the spans that split it.
CHILDREN = {"window_prepare": ("haplotypes", "pair_fill"),
            "window_finish": ("gl_prepass", "window_call"),
            "vcf_output": ("vcf_annotate", "vcf_genotypes", "vcf_write")}
STAGES = ("region_prepare", "region_begin", "region_finish")


class Clock:
    """perf_counter stand-in: each call returns the next of `ticks`."""

    def __init__(self, *ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return float(next(self.ticks))


def test_spans_nest_with_self_times(monkeypatch):
    """run holds a (region c:1-2) holding b.  Each span reads the clock
    when it is made and at its start, at its end and, below the outermost
    span, once more when its exit is done: the reads before a start and
    after an end are the span's own cost, which lies outside
    every span's seconds and is counted as span_overhead (b's and a's: 2
    each).  Totals run 20-1-4 = 15, a 12-3-2 = 7, b 8-5 = 3; self times
    8 / 4 / 3; b inherits a's region; all on the pipeline thread."""
    m = Metrics()
    monkeypatch.setattr(observability.time, "perf_counter",
                        Clock(0, 1, 2, 3, 4, 5, 8, 9, 12, 13, 20))
    with m.timer("run") as run:
        with m.timer("a", region="c:1-2") as a:
            with m.timer("b") as b:
                assert b.parent is a and a.parent is run
                assert b.region == "c:1-2" and run.region is None
    monkeypatch.undo()
    assert dict(m.timers) == {"run": 15.0, "a": 7.0, "b": 3.0,
                              "span_overhead": 4.0}
    assert m.snapshot()["self_times"] == {
        "pipeline": {"run": 8.0, "a": 4.0, "b": 3.0, "span_overhead": 4.0},
        "helper": {}}
    assert (a.start, a.end, b.start, b.end) == (3.0, 12.0, 5.0, 8.0)
    assert not any((run.helper, a.helper, b.helper))
    assert m._stacks == {}


def test_helper_thread_spans_are_kept_apart():
    """A span a helper thread opens while the pipeline thread is inside
    `run` counts in the helper's self times, is nobody's child, and takes
    nothing off the pipeline's spans; both sum into the totals."""
    m = Metrics()
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def helper():
        with m.timer("bam_decode", region="c:5-9") as span:
            seen["span"] = span
            inside.set()
            release.wait(10)

    with m.timer("run"):
        with m.timer("region_load"):
            thread = threading.Thread(target=helper)
            thread.start()
            assert inside.wait(10)
            release.set()
            thread.join()
    span = seen["span"]
    assert span.helper and span.parent is None and span.region == "c:5-9"
    snap = m.snapshot()
    assert set(snap["self_times"]["helper"]) == {"bam_decode"}
    assert set(snap["self_times"]["pipeline"]) == {"run", "region_load",
                                                   "span_overhead"}
    assert snap["self_times"]["pipeline"]["region_load"] == \
        snap["timers"]["region_load"]
    assert snap["timers"]["bam_decode"] == span.end - span.start


def test_no_record_function_without_a_profiler(monkeypatch):
    """With torch imported and no profiler session, a span enters no
    record_function; under a session it enters one per span."""
    entered = []

    class Recording:
        def __init__(self, name, args=None):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.profiler, "record_function", Recording)
    m = Metrics()
    with m.timer("run"), m.timer("a", region="c:1-2"):
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with m.timer("run"), m.timer("a", region="c:1-2"):
            pass
    assert entered == ["platypus.run", "platypus.a@c:1-2"]


def test_profiler_trace_holds_the_spans_with_their_region(tmp_path):
    """Under a CPU torch.profiler the spans are user annotations named
    platypus.<name>@<region>, the child's inside its parent's."""
    m = Metrics()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.timer("region_finish", region="chr20:1000-8500"):
            with m.timer("window_call"):
                torch.ones(8).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = {e["name"]: e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    outer = events["platypus.region_finish@chr20:1000-8500"]
    inner = events["platypus.window_call@chr20:1000-8500"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.fixture(scope="module")
def region_data(tmp_path_factory):
    """A 9 kb reference (seed 71) with five SNPs on one haplotype at 30x
    (seed 72); returns (bam, ref path)."""
    workdir = tmp_path_factory.mktemp("torch_spans")
    ref_path, ref_seq = make_reference(workdir, length=9000, seed=71)
    variants = [(p, 1, b"C" if ref_seq[p] != ord("C") else b"T")
                for p in (1500, 2500, 4500, 6500, 7500)]
    reads = simulate_reads(
        [SimHaplotype(ref_seq, []), SimHaplotype(ref_seq, variants)],
        1000, 8500, coverage=30, seed=72)
    return write_synth_bam(workdir, reads, ref_len=9000), ref_path


def _run_region(tmp_path, region_data, **config):
    """One region through run_single_process on the CPU from reset
    metrics; returns (GLOBAL_METRICS.snapshot(), wall seconds of the
    call, windows the fused inference returned)."""
    bam, ref_path = region_data
    inferred = []
    gather = batch.PendingInference.gather

    def counting(self):
        out = gather(self)
        inferred.append(len(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch.PendingInference, "gather", counting)
        GLOBAL_METRICS.reset()
        t0 = time.perf_counter()
        runner.run_single_process(
            PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                           buffer_size=8000, **config),
            [REGION], str(tmp_path / "out.vcf"), CPU)
        wall = time.perf_counter() - t0
    return GLOBAL_METRICS.snapshot(), wall, sum(inferred)


def test_one_region_is_covered_by_its_spans(tmp_path, region_data):
    """One CPU region with the fused inference on: the new children sum
    to within 5% of window_prepare, window_finish and vcf_output; the
    pipeline thread's time in no span below a stage is under 3% of the
    call; k3_windows equals the windows the inference returned (the plain
    version reports no EM iterations); the summary's reads/s divides by
    the run span."""
    snap, wall, inferred = _run_region(tmp_path, region_data,
                                       device_inference=1)
    timers, counters = snap["timers"], snap["counters"]
    for parent, children in CHILDREN.items():
        assert timers[parent] > 0
        assert abs(sum(timers[c] for c in children) - timers[parent]) \
            <= 0.05 * timers[parent], (parent, timers)
    for span in ("bam_decode", "window_layout", *STAGES, "run", "vcf_drain"):
        assert timers[span] > 0, span
    covered = sum(s for name, s in snap["self_times"]["pipeline"].items()
                  if name not in STAGES and name != "run")
    assert wall - covered < 0.03 * wall, (wall, snap["self_times"])
    assert inferred > 0 and counters["k3_windows"] == inferred
    assert "k3_em_iterations" not in counters
    assert counters["k3_batches"] >= 1
    assert 0 < timers["run"] <= wall
    summary = GLOBAL_METRICS.summary()
    rate = float(summary.split("reads/s=")[1].split()[0])
    assert rate == pytest.approx(counters["reads"] / timers["run"], rel=1e-3,
                                 abs=1)


def test_assembly_nests_under_candidate_generation(tmp_path, region_data,
                                                  monkeypatch):
    """With --assemble=1 (and --noCycles=1) the tile loop runs inside the
    span assembly, itself inside candidate_generation; assembly_tiles,
    assembly_variants and assembly_kmer_retries count the tiles the
    native call assembled, the variants it returned and its graphs built
    again after a cycle."""
    from platypus_tpu_torch import native
    from platypus_tpu_torch.candidates import assembly

    seen = {}
    region_call = native.native_assemble_region
    tile_loop = assembly.assemble_region_variants

    def native_call(tiles, *args):
        out = region_call(tiles, *args)
        seen.update(tiles=len(tiles), variants=sum(map(len, out[0])),
                    retries=out[1])
        return out

    def spanned(*args):
        stack = GLOBAL_METRICS._stacks[threading.get_ident()]
        seen["spans"] = [span.name for span in stack]
        return tile_loop(*args)

    monkeypatch.setattr(native, "native_assemble_region", native_call)
    monkeypatch.setattr(assembly, "assemble_region_variants", spanned)
    snap, _wall, _inferred = _run_region(tmp_path, region_data,
                                         device_inference=1, assemble=1,
                                         no_cycles=1)
    assert seen["spans"][-3:] == ["region_prepare", "candidate_generation",
                                  "assembly"]
    timers, counters = snap["timers"], snap["counters"]
    assert 0 < timers["assembly"] < timers["candidate_generation"]
    assert seen["tiles"] == len(range(*REGION[1:], 750))
    assert counters["assembly_tiles"] == seen["tiles"]
    assert counters["assembly_variants"] == seen["variants"] > 0
    assert counters["assembly_kmer_retries"] == seen["retries"]


def test_mesh_region_times_its_phases(tmp_path, region_data):
    """With --meshDevices=8 on the CPU the region's mesh step is timed as
    mesh_pack_launch, mesh_fetch and mesh_unpack, and its fetch counts
    the windows it inferred."""
    snap, _wall, _inferred = _run_region(tmp_path, region_data,
                                         mesh_devices=8)
    for span in ("mesh_pack_launch", "mesh_fetch", "mesh_unpack"):
        assert snap["timers"][span] > 0, span
    assert snap["counters"]["k3_windows"] > 0


def test_gather_counts_the_iterations_of_real_windows(tmp_path, region_data,
                                                      monkeypatch):
    """Through PendingInference.gather, with a result shaped like
    likelihood_cuda.launch's (the seven outputs and then each window's
    iterations: 7 for a real window, 10**6 for a pad one), k3_em_iterations
    counts the real windows' iterations alone:
    k3_windows <= k3_em_iterations <= 100 * k3_windows."""
    plain = likelihood_cuda.infer_window_batch

    def launch_shaped(*args, **kwargs):
        outs = plain(*args, **kwargs)
        real = args[2].any(dim=1)  # pad windows have no haplotype
        iters = torch.where(real, 7, 10 ** 6).to(torch.int32)
        return (*outs, iters)

    monkeypatch.setattr(likelihood_cuda, "infer_window_batch", launch_shaped)
    snap, _wall, inferred = _run_region(tmp_path, region_data,
                                        device_inference=1)
    windows = snap["counters"]["k3_windows"]
    iterations = snap["counters"]["k3_em_iterations"]
    assert windows == inferred > 0
    assert windows <= iterations <= 100 * windows
    assert iterations == 7 * windows


def test_trace_writes_the_run_metrics_beside_the_trace(tmp_path, region_data,
                                                       monkeypatch):
    """run_variant_caller with --nCPU=1 under PLATYPUS_TPU_TRACE_DIR: the
    Chrome trace of callVariants holds the platypus.* spans, and
    metrics.json beside it the run's totals, self times and counters."""
    bam, ref_path = region_data
    monkeypatch.setenv("PLATYPUS_TPU_TRACE_DIR", str(tmp_path / "traces"))
    GLOBAL_METRICS.reset()
    config = PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                            regions=["chr20:1001-8500"], buffer_size=8000,
                            output=str(tmp_path / "out.vcf"))
    runner.run_variant_caller(config, CPU)
    out = tmp_path / "traces" / "callVariants"
    with open(out / "metrics.json") as fh:
        saved = json.load(fh)
    assert saved["timers"]["run"] > 0 and saved["counters"]["reads"] > 0
    assert saved["self_times"]["pipeline"]["vcf_genotypes"] > 0
    (trace,) = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
    with open(out / trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert "platypus.run" in names
    assert "platypus.window_call@chr20:1000-8500" in names


@pytest.fixture
def program_metrics(monkeypatch):
    """A fresh Metrics in GLOBAL_METRICS' place, which the readers read."""
    metrics = Metrics()
    monkeypatch.setattr(observability, "GLOBAL_METRICS", metrics)
    return metrics


def _read(name, ctx):
    import importlib

    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def _context(timers):
    from portbench.harness.core import Context

    return Context(window_s=10.0, reads=2_000_000, region_s=[], setup_s=1.0,
                   timers=timers, trace=None, k1_bound_s=None,
                   k3_bound_s=None)


@pytest.mark.parametrize("metric,span", [
    ("bam_decode_s_per_mreads", "bam_decode"),
    ("window_layout_s_per_mreads", "window_layout"),
    ("haplotypes_s_per_mreads", "haplotypes"),
    ("window_call_s_per_mreads", "window_call"),
    ("vcf_annotate_s_per_mreads", "vcf_annotate"),
    ("vcf_genotypes_s_per_mreads", "vcf_genotypes"),
    ("assembly_s_per_mreads", "assembly")])
def test_span_readers(program_metrics, metric, span):
    """A span's total seconds over millions of reads; None where the
    program has no such span."""
    assert _read(metric, _context({span: 3.0, "other": 5.0})) == 1.5
    assert _read(metric, _context({"other": 5.0})) is None


def test_unspanned_reader(program_metrics):
    """The window less the pipeline's self times below the stages (the
    stages' and run's own left out, helper spans not counted)."""
    pipeline = program_metrics.self_times["pipeline"]
    pipeline.update(run=0.5, region_prepare=0.25, region_begin=0.125,
                    region_finish=0.125, haplotypes=4.0, vcf_write=3.0)
    program_metrics.self_times["helper"]["bam_decode"] = 2.0
    assert _read("unspanned_s_per_mreads", _context({})) == (10 - 7) / 2
    pipeline.clear()
    assert _read("unspanned_s_per_mreads", _context({})) is None


def test_counter_readers(program_metrics):
    """em_iters_per_window = k3_em_iterations / k3_windows and
    f64_guard_share = 100 * device_windows_to_host / k3_windows, each None
    without k3_windows (and the former without iterations)."""
    ctx = _context({})
    assert _read("em_iters_per_window", ctx) is None
    assert _read("f64_guard_share", ctx) is None
    program_metrics.count("k3_windows", 40)
    assert _read("em_iters_per_window", ctx) is None
    assert _read("f64_guard_share", ctx) == 0.0
    program_metrics.count("k3_em_iterations", 300)
    program_metrics.count("device_windows_to_host", 3)
    assert _read("em_iters_per_window", ctx) == 7.5
    assert _read("f64_guard_share", ctx) == 7.5


def test_assembly_ms_per_tile_reader(program_metrics):
    """The assembly span's milliseconds over assembly_tiles; None without
    the counter or without the span."""
    assert _read("assembly_ms_per_tile", _context({"assembly": 0.5})) is None
    program_metrics.count("assembly_tiles", 200)
    assert _read("assembly_ms_per_tile", _context({"assembly": 0.5})) == 2.5
    assert _read("assembly_ms_per_tile", _context({})) is None
