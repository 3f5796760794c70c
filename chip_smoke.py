#!/usr/bin/env python3
"""On-card smoke test of the torch port (platypus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
without either it exits non-zero before printing any result.  Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel library of align_cuda.KERNELS -- K1, the
   banded-alignment DP (csrc/band_align.cu), and K2, its traceback mode
   (csrc/band_align_tb.cu) -- one nvcc each for sm_90a, started together;
3. kernel: each CUDA kernel bitwise against its plain torch version on
   the card -- every reference golden (K2: the flank goldens, whose
   alignments the host backtrace must reproduce from K2's label words),
   and main-path shapes (B = 16384, 2048 and 2000 pairs at read lengths
   100 and 128, mixed lengths, 'N' bases) -- then each timed with CUDA
   events against its plain version at B=16384, L2=100;
4. slice: `platypus_tpu_torch.cli.main(["callVariants", ...])` on cuda
   over a synthetic 1 Mb, 30x, 100 bp dataset (ten 100 kb regions; built
   by tests/test_torch_smoke_data.py in a child process, as is the HLA
   panel, since their writers belong to the JAX package), with
   counters showing K1 and the fused inference ran (this first call also
   builds the native host library on a fresh checkout); then one more
   100 kb region with --maxHaplotypes=4 so the beam search aligns through
   K1 too;
5. reference: the JAX package's CLI pinned to the CPU (native kernels,
   float64 inference, no jax import) on the same data; the port's VCF
   data lines must be byte-identical to it in both runs.  For a like for
   like time, the port's CLI also runs in a fresh interpreter, as the
   reference does: both walls include interpreter start and imports;
6. flank: the whole slice again with --calculateFlankScore=1, which must
   launch K2 and lower some pair scores by the flank penalty; then
   chr20:1000-21000 with it, in this process and in a
   fresh interpreter, byte-identical to the CPU-pinned reference (whose
   scalar flank path takes ~6 ms per pair, hence the smaller region);
7. HLA: --HLATyping=1 on a synthetic typing panel (160 alleles of a 2 kb
   region on contig 6, 30x of 100 bp reads from two of them), which
   scores through K1: in this process, in a fresh interpreter and
   against the CPU-pinned reference, byte-identical.

Any ERROR record on the `platypus_tpu` logger fails the run (every
crash-containment path logs there).  The last two lines of stdout are the
kernel report and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens", "align_goldens.json")
FLANK_GOLDENS = os.path.join(REPO, "tests", "goldens", "flank_goldens.json")
DATASETS = os.path.join(REPO, "tests", "test_torch_smoke_data.py")
SLICE_MB = 1.0
TIMED_B, TIMED_L2 = 16384, 100
MAIN_SHAPES = [(16384, 100), (16384, 128), (2048, 100), (2048, 128),
               (2000, 100), (2000, 128)]
FLANK_REGION = "chr20:1000-21000"
HLA_ALLELES, HLA_REGION_LEN, HLA_COVERAGE = 160, 2000, 30


class ErrorRecords(logging.Handler):
    """Collects every ERROR (or worse) record of the platypus_tpu logger."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))

    def check(self, phase):
        if self.records:
            raise RuntimeError(f"{phase}: ERROR records logged:\n"
                               + "\n".join(self.records))


def golden_groups():
    """Reference goldens batched by (gapextend, nucprior)."""
    import numpy as np

    with open(GOLDENS) as fh:
        cases = json.load(fh)
    by_pen = {}
    for c in cases:
        by_pen.setdefault((c["gapextend"], c["nucprior"]), []).append(c)
    for (ge, npr), group in by_pen.items():
        L2 = max(len(c["read"]) for c in group)
        B = len(group)
        hap = np.zeros((B, L2 + 15), np.int32)
        go = np.zeros((B, L2 + 15), np.int32)
        read = np.zeros((B, L2), np.int32)
        qual = np.zeros((B, L2), np.int32)
        rl = np.zeros(B, np.int32)
        for i, c in enumerate(group):
            h = np.frombuffer(c["hap"].encode(), np.uint8)
            r = np.frombuffer(c["read"].encode(), np.uint8)
            hap[i, : len(h)] = h
            go[i, : len(h)] = c["gapopen"]
            read[i, : len(r)] = r
            qual[i, : len(r)] = c["quals"]
            rl[i] = len(r)
        yield ge, npr, (hap, go, read, qual, rl), np.array([c["score"] for c in group])


def flank_goldens():
    """The flank goldens (all gapextend 3, nucprior 2) as one batch:
    (cases, (hap, gap-open, read, qual, read length) numpy rows)."""
    import numpy as np

    with open(FLANK_GOLDENS) as fh:
        cases = json.load(fh)
    L2 = max(len(c["read"]) for c in cases)
    B = len(cases)
    hap = np.zeros((B, L2 + 15), np.int32)
    go = np.zeros((B, L2 + 15), np.int32)
    read = np.zeros((B, L2), np.int32)
    qual = np.zeros((B, L2), np.int32)
    rl = np.zeros(B, np.int32)
    for i, c in enumerate(cases):
        h = np.frombuffer(c["hap"].encode(), np.uint8)
        r = np.frombuffer(c["read"].encode(), np.uint8)
        hap[i, : len(h)] = h
        go[i, : len(h)] = c["gapopen"]
        read[i, : len(r)] = r
        qual[i, : len(r)] = c["quals"]
        rl[i] = len(r)
    return cases, (hap, go, read, qual, rl)


def flank_golden_mismatches(cases, score, idx, bp):
    """Indices of the flank goldens whose score, or whose alignment rows,
    first position and flank penalty as the host backtrace recovers them
    from the traceback kernel's (score, idx, bp) numpy outputs, differ
    from the golden."""
    import numpy as np

    from platypus_tpu_torch.engine.score import (calculate_flank_score,
                                                 traceback_from_backpointers,
                                                 unpack_backpointers)

    bad = []
    for k, c in enumerate(cases):
        aln1, aln2, firstpos = traceback_from_backpointers(
            unpack_backpointers(bp[:, k]), int(idx[k]), c["hap"].encode(),
            c["read"].encode())
        flank = calculate_flank_score(
            len(c["hap"]), c["flank"], np.array(c["quals"]),
            np.array(c["gapopen"]), c["gapextend"], c["nucprior"], firstpos,
            aln1, aln2)
        if (int(score[k]), aln1.decode(), aln2.decode(), firstpos, flank) != (
                c["score"], c["aln1"], c["aln2"], c["firstpos"],
                c["flank_score"]):
            bad.append(k)
    return bad


def random_pairs(seed, B, L2):
    """Main-path-like pairs: reads cut from the haplotype at a band offset
    with point mutations and 1% 'N' bases, mixed read lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, size=(B, L2 + 15)).astype(np.int32)
    go = rng.integers(3, 50, size=(B, L2 + 15)).astype(np.int32)
    off = rng.integers(0, 8, size=B)
    read = hap[np.arange(B)[:, None], off[:, None] + np.arange(L2)[None, :]].copy()
    mut = rng.random(read.shape) < 0.02
    read[mut] = rng.choice(bases, int(mut.sum()))
    hap[rng.random(hap.shape) < 0.01] = ord("N")
    read[rng.random(read.shape) < 0.01] = ord("N")
    qual = rng.integers(0, 60, size=(B, L2)).astype(np.int32)
    rl = rng.integers(L2 // 2, L2 + 1, size=B).astype(np.int32)
    rl[: B // 4] = L2
    return hap, go, read, qual, rl


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel(device):
    """Phase 3: bitwise parity on goldens and main-path shapes, then the
    kernel's and the plain version's times.  Returns the report fields."""
    import torch

    from platypus_tpu_torch.ops import align_cuda, align_torch

    max_err = 0
    n_pairs = 0
    cases = [(ge, npr, inputs) for ge, npr, inputs, _ in golden_groups()]
    for seed, (B, L2) in enumerate(MAIN_SHAPES):
        cases.append((3, 2, random_pairs(seed, B, L2)))
    for k, (ge, npr, inputs) in enumerate(cases):
        padded = align_torch.pad_alignment_inputs(*inputs, device=device)
        got = align_cuda.band_align_padded(*padded, gapextend=ge, nucprior=npr)
        want = align_torch.band_align_padded_reference(*padded, gapextend=ge,
                                                       nucprior=npr)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_pairs += got.numel()
        if err:
            raise AssertionError(f"kernel != plain DP on case {k} "
                                 f"(B={got.numel()}): max |diff| {err}")
    print(f"kernel: bitwise equal to the plain DP on {len(cases)} batches, "
          f"{n_pairs} pairs (goldens + main-path shapes)", flush=True)

    padded = align_torch.pad_alignment_inputs(*random_pairs(99, TIMED_B, TIMED_L2),
                                              device=device)
    ms = cuda_ms(lambda: align_cuda.band_align_padded(*padded), 20)
    plain_ms = cuda_ms(lambda: align_torch.band_align_padded_reference(*padded), 3)
    print(f"kernel: B={TIMED_B} L2={TIMED_L2}: cuda {ms:.6f} ms "
          f"({TIMED_B / ms * 1e3:.1f} pairs/s), plain torch {plain_ms:.6f} ms "
          f"({TIMED_B / plain_ms * 1e3:.1f} pairs/s)", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def check_tb_kernel(device):
    """Phase 3 for K2: score, exit index and the whole label block bitwise
    equal to the plain traceback DP on the flank goldens and main-path
    shapes, the goldens' alignments recovered from K2's output by the host
    backtrace, then both timed.  Returns the report fields."""
    import torch

    from platypus_tpu_torch.ops import align_cuda, align_torch

    golden_cases, golden_inputs = flank_goldens()
    cases = [golden_inputs] + [random_pairs(100 + seed, B, L2)
                               for seed, (B, L2) in enumerate(MAIN_SHAPES)]
    max_err = 0
    n_pairs = 0
    for k, inputs in enumerate(cases):
        padded = align_torch.pad_alignment_inputs(*inputs, device=device)
        got = align_cuda.band_align_traceback_padded(*padded)
        want = align_torch.band_align_traceback_padded_reference(*padded)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        max_err = max(max_err, err)
        n_pairs += got[0].numel()
        if err:
            raise AssertionError(f"traceback kernel != plain DP on case {k} "
                                 f"(B={got[0].numel()}): max |diff| {err}")
        if k == 0:
            bad = flank_golden_mismatches(golden_cases,
                                          *(t.cpu().numpy() for t in got))
            if bad:
                raise AssertionError(f"traceback kernel: flank goldens {bad} "
                                     "not reproduced by the host backtrace")
    print(f"kernel K2: score, idx and bp bitwise equal to the plain traceback "
          f"DP on {len(cases)} batches, {n_pairs} pairs (flank goldens + "
          f"main-path shapes); {len(golden_cases)} flank goldens' alignments "
          f"and flank scores reproduced", flush=True)

    padded = align_torch.pad_alignment_inputs(*random_pairs(99, TIMED_B, TIMED_L2),
                                              device=device)
    ms = cuda_ms(lambda: align_cuda.band_align_traceback_padded(*padded), 20)
    plain_ms = cuda_ms(
        lambda: align_torch.band_align_traceback_padded_reference(*padded), 3)
    print(f"kernel K2: B={TIMED_B} L2={TIMED_L2}: cuda {ms:.6f} ms "
          f"({TIMED_B / ms * 1e3:.1f} pairs/s), plain torch {plain_ms:.6f} ms "
          f"({TIMED_B / plain_ms * 1e3:.1f} pairs/s)", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def build_dataset(kind, workdir, *args):
    """A synthetic dataset built (or reused) in `workdir` by
    `python tests/test_torch_smoke_data.py kind workdir args...` in a child
    process -- its writers belong to the JAX package, which this script does
    not import.  Returns the dataset's description (a dict of paths)."""
    proc = subprocess.run([sys.executable, DATASETS, kind, workdir,
                           *map(str, args)], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"building the {kind} dataset failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def hla_args(info, out):
    """callVariants arguments of an HLA typing run over `info`'s panel."""
    return ["callVariants", f"--bamFiles={info['bam']}",
            f"--refFile={info['ref']}", f"--regions={info['region']}",
            "--HLATyping=1", f"--source={info['panel']}", "--longHaps=1",
            "--assemble=0", "--getVariantsFromBAMs=0",
            f"--logFileName={out}.log", "--verbosity=1", "-o", out]


def data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def cli_args(info, region, out, extra=()):
    return ["callVariants", f"--bamFiles={info['bam']}",
            f"--refFile={info['ref']}", f"--regions={region}",
            f"--logFileName={out}.log", "--verbosity=1", *extra, "-o", out]


def reset_counts():
    """Zero every kernel's launch count and the fused-inference count."""
    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.parallel import batch

    for name in align_cuda.LAUNCHES:
        align_cuda.LAUNCHES[name] = 0
    batch.BATCHES = 0


def read_counts():
    """Launches per kernel library, fused-inference batches and pairs whose
    score the flank penalty lowered, since the last reset_counts() (and
    metrics.reset())."""
    from platypus_tpu_torch.engine.region import metrics
    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.parallel import batch

    return dict(align_cuda.LAUNCHES, batches=batch.BATCHES,
                flank_pairs_lowered=metrics.counters["flank_pairs_lowered"])


def run_port(argv):
    """The port's CLI on cuda, in this process; prints the engine's stage
    timers (host clock; device stages are queue + wait times) and returns
    (wall seconds, read_counts() of this run)."""
    import torch

    from platypus_tpu_torch import cli
    from platypus_tpu_torch.engine.region import metrics

    metrics.reset()
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise RuntimeError(f"port CLI returned {rc}")
    print(f"stages: {metrics.summary()}", flush=True)
    return wall, counts


def run_cli(package, argv, env=None):
    """`python -m <package>.cli <argv>` in a fresh interpreter; returns its
    wall seconds (interpreter start and imports included)."""
    cmd = [sys.executable, "-m", f"{package}.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{package} CLI failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return wall


def run_port_cli(argv, out):
    """The port's CLI on cuda in a fresh interpreter; fails on any ERROR
    line of its log (`out`.log).  Returns its wall seconds."""
    wall = run_cli("platypus_tpu_torch", argv)
    with open(f"{out}.log") as fh:
        errors = [line for line in fh if " - ERROR - " in line
                  or " - CRITICAL - " in line]
    if errors:
        raise RuntimeError("port CLI logged ERROR records:\n" + "".join(errors))
    return wall


def run_reference(argv):
    """The JAX package's CLI pinned to the CPU, in a fresh interpreter;
    returns its wall seconds.  PLATYPUS_TPU_DEVICE_FLANK=0 keeps its
    --calculateFlankScore path from importing jax, which this host may
    not have."""
    env = dict(os.environ, PLATYPUS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               PLATYPUS_TPU_DEVICE_FLANK="0")
    return run_cli("platypus_tpu", [argv[0], "--deviceInference=0", *argv[1:]],
                   env=env)


def check_same_calls(what, ref_out, *port_outs):
    """Every port VCF's data lines byte-identical to the reference's;
    returns the number of data lines."""
    ref_lines = data_lines(ref_out)
    for out in port_outs:
        port_lines = data_lines(out)
        if not ref_lines or port_lines != ref_lines:
            raise AssertionError(f"{what}: {out} differs from the reference: "
                                 f"{len(port_lines)} vs {len(ref_lines)} data lines")
    return len(ref_lines)


def compare_three(what, workdir, name, argv_of):
    """`argv_of(out)` through the port in this process, the port's CLI in
    a fresh interpreter and the CPU-pinned reference; the data lines must
    be byte-identical.  Returns (in-process wall, its counts, fresh port
    wall, reference wall, number of data lines)."""
    port_out = os.path.join(workdir, f"port_{name}.vcf")
    wall, counts = run_port(argv_of(port_out))
    cli_out = os.path.join(workdir, f"port_cli_{name}.vcf")
    cli_wall = run_port_cli(argv_of(cli_out), cli_out)
    ref_out = os.path.join(workdir, f"reference_{name}.vcf")
    ref_wall = run_reference(argv_of(ref_out))
    n_lines = check_same_calls(what, ref_out, port_out, cli_out)
    return wall, counts, cli_wall, ref_wall, n_lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from platypus_tpu_torch.engine import caller as port_caller
    from platypus_tpu_torch.ops import align_cuda

    errors = ErrorRecords()
    logging.getLogger("platypus_tpu").addHandler(errors)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)", flush=True)

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(align_cuda.KERNELS)) as pool:
        list(pool.map(align_cuda.build, align_cuda.KERNELS))
    for name in align_cuda.KERNELS:
        align_cuda.load(name)
    print(f"build: {', '.join(align_cuda.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for name in align_cuda.KERNELS:
        for line in align_cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: ptxas: {line.strip()}", flush=True)

    # 3. kernel
    report = {"band_align": check_kernel(device),
              "band_align_tb": check_tb_kernel(device)}
    errors.check("kernel")

    # 4. slice on cuda, 5. the CPU-pinned reference on the same data
    t0 = time.perf_counter()
    workdir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                           f"mb{SLICE_MB:g}")
    info = build_dataset("slice", workdir, SLICE_MB)
    info["workdir"] = workdir
    print(f"slice: dataset {info['n_reads']} reads over {info['length']} bp "
          f"({time.perf_counter() - t0:.3f} s to build or load)", flush=True)
    region = f"chr20:1000-{info['length'] + 1000}"
    port_out = os.path.join(info["workdir"], "port.vcf")
    wall, counts = run_port(cli_args(info, region, port_out))
    errors.check("slice")
    launches = {"band_align": counts["band_align"]}
    if counts["band_align"] <= 0 or counts["batches"] <= 0:
        raise AssertionError(f"main path missed the card: {counts}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the port's main path")
    print(f"slice: port on cuda in this process (first call) {wall:.6f} s, "
          f"{info['n_reads'] / wall:.1f} reads/s, {counts['band_align']} "
          f"kernel launches, {counts['batches']} fused-inference batches",
          flush=True)

    cli_out = os.path.join(info["workdir"], "port_cli.vcf")
    cli_wall = run_port_cli(cli_args(info, region, cli_out), cli_out)
    ref_out = os.path.join(info["workdir"], "reference.vcf")
    ref_wall = run_reference(cli_args(info, region, ref_out))
    n_lines = check_same_calls("slice", ref_out, port_out, cli_out)
    print(f"reference: fresh interpreters, port CLI on cuda {cli_wall:.6f} s "
          f"({info['n_reads'] / cli_wall:.1f} reads/s), CPU-pinned platypus_tpu "
          f"{ref_wall:.6f} s ({info['n_reads'] / ref_wall:.1f} reads/s); "
          f"{n_lines} VCF data lines byte-identical", flush=True)

    beam = {"calls": 0, "launches": 0}
    inner = port_caller._beam_search_haplotypes

    def counting_beam(*args, **kwargs):
        before = align_cuda.LAUNCHES["band_align"]
        out = inner(*args, **kwargs)
        beam["calls"] += 1
        beam["launches"] += align_cuda.LAUNCHES["band_align"] - before
        return out

    port_caller._beam_search_haplotypes = counting_beam
    beam_region = "chr20:1000-101000"
    extra = ("--maxHaplotypes=4",)
    try:
        beam_wall, _, cli_beam_wall, ref_beam_wall, n_lines = compare_three(
            "--maxHaplotypes=4", info["workdir"], "beam",
            lambda out: cli_args(info, beam_region, out, extra))
    finally:
        port_caller._beam_search_haplotypes = inner
    errors.check("beam search")
    if beam["calls"] <= 0 or beam["launches"] <= 0:
        raise AssertionError(f"beam search did not run through the kernel: {beam}")
    print(f"beam: {beam['calls']} beam searches, {beam['launches']} kernel "
          f"launches; port in this process {beam_wall:.6f} s; fresh "
          f"interpreters: port CLI {cli_beam_wall:.6f} s, reference "
          f"{ref_beam_wall:.6f} s; {n_lines} VCF data lines byte-identical",
          flush=True)
    errors.check("reference")

    # 6. --calculateFlankScore=1: the whole slice through K2, then a small
    # region byte for byte against the reference's scalar flank path
    flank = ("--calculateFlankScore=1",)
    flank_out = os.path.join(info["workdir"], "port_flank.vcf")
    wall, counts = run_port(cli_args(info, region, flank_out, flank))
    errors.check("flank slice")
    launches["band_align_tb"] = counts["band_align_tb"]
    if counts["band_align_tb"] <= 0 or counts["flank_pairs_lowered"] <= 0:
        raise AssertionError(f"flank path missed K2 or changed no score: "
                             f"{counts}")
    print(f"flank: whole slice on cuda in this process {wall:.6f} s, "
          f"{info['n_reads'] / wall:.1f} reads/s, {counts['band_align_tb']} K2 "
          f"launches, {counts['band_align']} K1 launches, "
          f"{counts['flank_pairs_lowered']} pair scores lowered by the flank "
          f"penalty, {len(data_lines(flank_out))} VCF data lines", flush=True)
    wall, counts, cli_wall, ref_wall, n_lines = compare_three(
        "--calculateFlankScore=1", info["workdir"], "flank_region",
        lambda out: cli_args(info, FLANK_REGION, out, flank))
    errors.check("flank region")
    if counts["band_align_tb"] <= 0 or counts["flank_pairs_lowered"] <= 0:
        raise AssertionError(f"flank region missed K2 or changed no score: "
                             f"{counts}")
    print(f"flank: {FLANK_REGION}: port in this process {wall:.6f} s "
          f"({counts['band_align_tb']} K2 launches, "
          f"{counts['flank_pairs_lowered']} pair scores lowered); fresh interpreters: port "
          f"CLI {cli_wall:.6f} s, reference {ref_wall:.6f} s; {n_lines} VCF "
          f"data lines byte-identical", flush=True)

    # 7. --HLATyping=1 on a synthetic typing panel, scored through K1
    t0 = time.perf_counter()
    hla_dir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                           f"hla{HLA_ALLELES}x{HLA_REGION_LEN}")
    hla = build_dataset("hla", hla_dir, HLA_ALLELES, HLA_REGION_LEN,
                        HLA_COVERAGE)
    print(f"hla: panel of {HLA_ALLELES} alleles over {hla['region']}, "
          f"{HLA_COVERAGE}x ({time.perf_counter() - t0:.3f} s to build or "
          f"load)", flush=True)
    wall, counts, cli_wall, ref_wall, n_lines = compare_three(
        "--HLATyping=1", hla_dir, "hla", lambda out: hla_args(hla, out))
    errors.check("hla")
    if counts["band_align"] <= 0:
        raise AssertionError(f"HLA path missed K1: {counts}")
    print(f"hla: port in this process {wall:.6f} s ({counts['band_align']} K1 "
          f"launches); fresh interpreters: port CLI {cli_wall:.6f} s, "
          f"reference {ref_wall:.6f} s; {n_lines} VCF data lines "
          f"byte-identical", flush=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the port")

    print(json.dumps({"kernels": [
        dict(name=lib, route="cuda", source=f"platypus_tpu_torch/csrc/{lib}.cu",
             replaces=kernel.replaces, launches=launches[lib], **report[lib])
        for lib, kernel in align_cuda.KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
