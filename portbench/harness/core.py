"""One run of one cell: the dataset from the seed, set-up, the measured
window through platypus_tpu_torch.engine.runner.run_single_process in this
process, the metrics, and the comparison that decides `correct`.

Everything a cell needs is found by name: its entry in BENCHMARK.json,
configs/<config>.json (the file BENCHMARK.json names), traffic/<traffic>.json
(which names its generator, traffic/<generator>.py), limits/<cell>.json
(each compared number's limit, or null for a number reported as a reading
and not compared) and metrics/<metric>.py (one reader a
metric, `read(ctx)` -> a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from portbench.harness.faults import planted
from portbench.harness.probes import SPAN_PREFIX, STAGES, Probes, installed

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(HERE, ".cache")
KEEP_DATASETS = 2  # datasets kept in the cache, this run's included


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    metrics: list   # the BENCHMARK.json metric entries this cell reports


def load_cell(root: str, name: str, trace: bool) -> Cell:
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if name in m.get("workloads", [name])]
    return Cell(name, cell["config"], load_json(root, entry["file"]),
                cell["traffic"], load_json(HERE, "traffic",
                                           cell["traffic"] + ".json"),
                load_json(HERE, "limits", name + ".json"), cell["chips"],
                metrics)


def dataset(cell: Cell, seed: int):
    """(directory, meta, seconds spent building) of the cell's dataset for
    `seed`, built into portbench/.cache unless it is there already."""
    key = f"{cell.config_name}-{cell.traffic_name}-{seed}"
    path = os.path.join(CACHE, key)
    if os.path.exists(os.path.join(path, "meta.json")):
        return path, load_json(path, "meta.json"), 0.0
    os.makedirs(CACHE, exist_ok=True)
    old = sorted((d for d in os.listdir(CACHE) if d != key),
                 key=lambda d: os.path.getmtime(os.path.join(CACHE, d)))
    for d in old[:max(0, len(old) - (KEEP_DATASETS - 1))]:
        shutil.rmtree(os.path.join(CACHE, d), ignore_errors=True)
    t0 = time.perf_counter()
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    gen = importlib.import_module(
        f"portbench.traffic.{cell.traffic['generator']}")
    gen.build(tmp, cell.config, cell.traffic, seed)
    os.replace(tmp, path)
    return path, load_json(path, "meta.json"), time.perf_counter() - t0


@dataclasses.dataclass
class Window:
    """What the region source and on_region_done saw."""
    seconds: float
    regions: list
    vcf: str
    yields: list = dataclasses.field(default_factory=list)  # (index, t)
    dones: list = dataclasses.field(default_factory=list)   # (region, t, bytes)
    start: Optional[float] = None
    end: Optional[float] = None
    span: object = None

    def source(self, trace_span):
        """The dataset's regions in order, cycling, until `seconds` have
        passed since the first yield."""
        k = 0
        while True:
            now = time.perf_counter()
            if self.start is None:
                self.start = now
                if trace_span is not None:
                    self.span = trace_span()
                    self.span.__enter__()
            elif now - self.start >= self.seconds:
                return
            self.yields.append((k % len(self.regions), now))
            k += 1
            yield tuple(self.regions[(k - 1) % len(self.regions)])

    def done(self, region) -> None:
        self.dones.append((tuple(region), time.perf_counter(),
                           os.path.getsize(self.vcf)))


@dataclasses.dataclass
class Context:
    """What the metric readers read (metrics/<name>.py read(ctx))."""
    window_s: float
    reads: int
    region_s: list            # per yielded region: yield to done, seconds
    setup_s: float
    timers: dict              # GLOBAL_METRICS timers of the window
    trace: Optional[dict]     # harness/trace.summarize of the window
    k1_bound_s: Optional[float]  # summed least times of K1's launches
    k3_bound_s: Optional[float]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device=None, substitute: Optional[str] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run `cell` (load_cell) once and return its result object (the
    line's keys, 'readings' and then 'checks' last).  `t0` is the
    process's start on the perf_counter clock.  `device` None is cuda:0;
    `substitute` names a control or a fault of harness/faults.py to put in
    place for the run (never with `trace`); `overrides` are PlatypusConfig
    fields set over the configuration's (the CPU tests'
    device_inference)."""
    if substitute is not None and trace:
        raise ValueError("a control or a fault runs untraced")
    ds_dir, meta, build_s = dataset(cell, seed)
    print(f"portbench: dataset {os.path.basename(ds_dir)} built in "
          f"{build_s:.3f} s", file=sys.stderr)

    import torch

    from platypus_tpu_torch import native
    from platypus_tpu_torch.config import PlatypusConfig
    from platypus_tpu_torch.engine import runner
    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.utils.observability import GLOBAL_METRICS

    device = torch.device("cuda", 0) if device is None else device
    native.load()
    if device.type == "cuda":
        torch.cuda.init()
        for lib in align_cuda.KERNELS:
            align_cuda.load(lib)
    opts = dict(cell.config["platypus"], **(overrides or {}))
    pcfg = PlatypusConfig(bam_files=[os.path.join(ds_dir, b)
                                     for b in meta["bams"]],
                          ref_file=os.path.join(ds_dir, meta["ref"]), **opts)
    probes = Probes(seed, trace)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        with planted(substitute), installed(probes):
            runner.run_single_process(dataclasses.replace(pcfg),
                                      [tuple(meta["regions"][0])],
                                      os.path.join(tmp, "warm.vcf"), device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            GLOBAL_METRICS.reset()
            probes.reset()
            win = Window(seconds, meta["regions"], os.path.join(tmp, "w.vcf"))
            prof = None
            if trace:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            span = ((lambda: torch.profiler.record_function(
                "portbench.window")) if trace else None)
            runner.run_single_process(pcfg, win.source(span), win.vcf, device,
                                      on_region_done=win.done)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            win.end = time.perf_counter()
            if win.span is not None:
                win.span.__exit__(None, None, None)
            setup_s = win.start - t0 - build_s
            timers = dict(GLOBAL_METRICS.timers)
            summary = None
            t_closed = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                from portbench.harness import trace as tr
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                summary = tr.summarize(
                    tr.load_events(path),
                    spans=[SPAN_PREFIX + s for s in STAGES])
                os.unlink(path)
                print(f"portbench: trace read in "
                      f"{time.perf_counter() - t_closed:.3f} s", file=sys.stderr)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        k1_bound = k3_bound = None
        if trace and device.type == "cuda":
            t_bounds = time.perf_counter()
            k1_bound, k3_bound = _bounds(probes)
            print(f"portbench: kernel bounds of {len(probes.k1_all)} K1 and "
                  f"{len(probes.k3_all)} K3 launches in "
                  f"{time.perf_counter() - t_bounds:.3f} s", file=sys.stderr)
        region_s = _region_times(win)
        reads = sum(meta["reads_per_region"][i] for i, _t in win.yields)
        ctx = Context(win.end - win.start, reads, region_s, setup_s, timers,
                      summary, k1_bound, k3_bound)
        metrics = {}
        for m in cell.metrics:
            value = importlib.import_module(
                f"portbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t_compare = time.perf_counter()
        numbers = compare(probes, win, meta, ds_dir)
        print(f"portbench: comparison in {time.perf_counter() - t_compare:.3f} s",
              file=sys.stderr)
        failed = len(win.yields) - probes.finished
        probes.reset()
        checks = {k: {"value": v, "limit": cell.limits[k]}
                  for k, v in numbers.items() if cell.limits[k] is not None}
        readings = {k: v for k, v in numbers.items()
                    if cell.limits[k] is None}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        result = dict(correct=correct, attempted=len(win.yields),
                      failed=failed,
                      metrics=metrics,
                      device=dict(platform="gpu" if device.type == "cuda"
                                  else device.type,
                                  kind=(torch.cuda.get_device_name(0)
                                        if device.type == "cuda" else "cpu"),
                                  count=1,
                                  memory_peak_bytes=peak))
        if summary is not None:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = dict(device_ops=summary["device_ops"],
                                       idle_gaps=summary["idle_gaps"])
        result["readings"] = readings
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _region_times(win: Window):
    """Per yielded region, seconds from its yield to its on_region_done,
    matching each done with the earliest open yield of its region."""
    open_ = {}
    for i, t in win.yields:
        open_.setdefault(tuple(win.regions[i]), []).append(t)
    out = []
    for region, t, _size in win.dones:
        out.append(t - open_[region].pop(0))
    return out


def _bounds(probes: Probes):
    """Summed least times of every K1 and K3 launch of the window
    (harness/roofline.py), against card 0's rates."""
    from portbench.harness import roofline

    clock = roofline.card_rates(0)
    k1 = sum(roofline.k1_bound_s(hap, seq, [t.cpu().numpy() for t in idx],
                                 clock)
             for hap, seq, idx in probes.k1_all)
    k3 = 0.0
    for args, iters in probes.k3_all:
        arrays = [a.cpu().numpy() for a in args]
        k3 += roofline.k3_bound_s(roofline.k3_work(arrays, iters.cpu().numpy()),
                                  clock)
    return k1, k3


def compare(probes: Probes, win: Window, meta: dict, ds_dir: str) -> dict:
    """The numbers `correct` is decided on: K1's sampled launches
    against the plain DP (pairs whose score differs), K3's sampled batches
    against the plain inference in float64 (the widest gaps), and the
    window's VCF records against the planted variants."""
    from portbench.reference import dp, em

    mismatches = 0
    for args, out, ge, npr in probes.k1.sample():
        want = dp.band_align_pairs(*args, gapextend=ge, nucprior=npr)
        mismatches += int((want != out).sum())
    gl_gap = post_gap = 0.0
    for args, outs, em_iters in probes.k3.sample():
        ll, oh = args[0].double(), args[1].double()
        want = em.infer_window_batch(ll, oh, *args[2:], em_iters=em_iters)
        gl_gap = max(gl_gap, _gap(outs[5], want[5], relative=True))
        # freq, responsibilities and the ratios of the variant slots in use,
        # of the windows whose EM stop is clear on both sides
        ok = (want[6] >= EM_MARGIN) & (outs[6].double() >= EM_MARGIN)
        slots = args[5].any(dim=2)[ok]
        post_gap = max(post_gap, _gap(outs[2][ok], want[2][ok]),
                       _gap(outs[1][ok], want[1][ok]),
                       _gap(outs[4][ok][slots], want[4][ok][slots],
                            relative=True))
    tally = _judge_calls(win, meta, ds_dir)
    numbers = dict(
        k1_mismatches=float(mismatches),
        k3_gl_gap=gl_gap,
        k3_post_gap=post_gap,
        missed_share=tally.missed / max(1, tally.sites),
        genotype_error_share=tally.genotype_errors / max(1, tally.genotypes),
        extra_per_mb=tally.extra / max(1, tally.bp) * 1e6,
        regions_skipped=float(len(win.yields) - probes.finished),
    )
    return numbers


# Windows whose EM stopping test sits within this of its tolerance may stop
# an iteration apart in float32 and float64; the program's own guard sends
# them to its float64 host path (engine/caller.py _EM_MARGIN_EPS).
EM_MARGIN = 1e-5


def _gap(got, want, relative: bool = False) -> float:
    """The widest |got - want| (over 1 + |want| if relative); an entry
    where either side is not finite counts as infinitely far unless both
    are the same non-finite value."""
    got, want = got.double(), want.double()
    if got.numel() == 0:
        return 0.0
    finite = want.isfinite() & got.isfinite()
    same = (got == want) | (got.isnan() & want.isnan())
    if bool((~finite & ~same).any()):
        return float("inf")
    d = (got - want).abs()
    if relative:
        d = d / (1 + want.abs())
    d = d[finite]
    return float(d.max()) if d.numel() else 0.0


def _judge_calls(win: Window, meta: dict, ds_dir: str):
    """The calls of every region the window finished, judged against the
    planted variants (reference/calls.py)."""
    from portbench.reference import calls

    with open(os.path.join(ds_dir, meta["ref"]), "rb") as fh:
        fh.readline()
        ref = np.frombuffer(fh.read().replace(b"\n", b""), np.uint8)
    truth = sorted((int(p), int(n), alt.encode(), gt) for (p, n, alt), gt in
                   ((k.split(":"), g) for k, g in meta["truth"].items()))
    tpos = np.array([t[0] for t in truth], np.int64)
    with open(win.vcf, "rb") as fh:
        text = fh.read().decode()
    tally = calls.Tally()
    prev = None
    for region, _t, size in win.dones:
        if prev is None:
            header_end = text.rfind("\n#CHROM")
            prev = text.index("\n", header_end + 1) + 1
        records = calls.parse_records(text[prev:size])
        prev = size
        _chrom, start, end = region
        lo, hi = np.searchsorted(tpos, [start, end])
        tally.add(calls.judge_region(ref, start, end, records, truth[lo:hi]))
    return tally
