#!/usr/bin/env python3
"""On-card smoke test of the torch port (platypus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
without either it exits non-zero before printing any result.  Every port
CLI that runs in a fresh interpreter does so under a sitecustomize.py
(BLOCKER) that makes `import platypus_tpu` and `import jax` raise, in
that process and in every process it spawns; the port imports nothing of
the JAX package.  Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel library of align_cuda.KERNELS -- K1, the
   banded-alignment DP (csrc/band_align.cu), and K2, its traceback mode
   (csrc/band_align_tb.cu) -- one nvcc each for sm_90a, and the port's
   native host library (platypus_tpu_torch/native/src, g++), all started
   together; prints the native library's path and each kernel's loop in
   SASS (cuobjdump), beside the operations bound() counts;
3. kernel: each CUDA kernel bitwise against its plain torch version on
   the card -- every reference golden (K2: the flank goldens, whose
   alignments the host backtrace must reproduce from K2's label words),
   and main-path shapes (B = 16384, 2048 and 2000 pairs at read lengths
   100 and 128, mixed lengths, 'N' bases) -- then each timed with CUDA
   events at B=16384, L2=100 (on the device alone, its launches queued
   behind a sleep kernel, and back to back as the host launches them)
   against its plain version, with its bound:
   the larger of the bytes it must move over the card's memory rate and
   its int32 operations over the card's int32 rate (bound());
4. slice: `platypus_tpu_torch.cli.main(["callVariants", ...])` on cuda
   over a synthetic 1 Mb, 30x, 100 bp dataset (ten 100 kb regions; built
   by tests/test_torch_smoke_data.py in a child process, as is the HLA
   panel, since their writers belong to the JAX package), with
   counters showing K1 and the fused inference ran; then one more
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
   against the CPU-pinned reference, byte-identical;
8. pool: the slice with --nCPU=4 (auto policy: four host workers and at
   most one device worker) through the port's CLI and through the
   CPU-pinned reference's, byte-identical to each other and to the
   single-process lines; prints both walls and the claim counts;
9. hybrid: --nCPU=2 --tpuWorkers=1 with the settle gate off and
   --calculateFlankScore=1 on HYBRID_REGION, where the host workers take
   the scalar flank path (~6 ms per pair) while the device worker runs
   K2: the device worker must call regions and launch K2 there (its own
   counts, reported back through the pool's summary line), and the lines
   must equal the CPU-pinned reference's;
10. service: --nCPU=2 --tpuWorkers=0 --inferenceService=1 on the slice:
   the device-owner service must serve windows with no error, and the
   lines must equal the single-process reference's;
11. resume: the single-process slice output cut after its middle data
   line, continued by `continueCalling` through the port's CLI and the
   CPU-pinned reference's: both continuations byte-identical, their data
   lines those of the full run;
12. mesh CLI: the slice, and FLANK_REGION with --calculateFlankScore=1,
   each with --meshDevices=-1 through the port's CLI in a fresh
   interpreter that reports its kernel launches: byte-identical to the
   reference's default runs, with K1 (K2) launched and the [mesh] timers
   printed;
13. mesh shards: in this process, mesh_call_region over a slice region
   and over FLANK_REGION in flank mode on a 1-shard mesh, a 2-shard mesh
   on cuda:0 and, with two cards or more, a mesh of every card: pair
   scores bitwise equal and calls identical to each other and to the
   float64 host path (graft_entry.check_mesh_region);
14. dry run: graft_entry.dryrun_multichip on every card, and the demo
   step on a 2-shard mesh of cuda:0 against a 1-shard one;
15. distributed: --distributed=1 as two fresh processes under torchrun's
   environment (gloo; rank r on cuda:{r % cards}) over the slice, merged
   byte-identical to the reference.

Any ERROR record on the `platypus_tpu` logger fails the run (every
crash-containment path logs there), and so does a module of the JAX
package in this process's sys.modules at the end.  The last two lines of
stdout are the kernel report and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --walls-against OTHER_CHECKOUT [--pairs 4]

runs none of those phases: it times fresh port CLIs on the 1 Mb slice,
OTHER_CHECKOUT's (for example an unpacked `git archive` of the parent
commit; without the blocker, since an older port may import the JAX
package) and this checkout's, alternating, each checkout warmed once
(its builds), every run's data lines equal; its last line is a JSON
summary of the walls.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
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
HYBRID_REGION, HYBRID_SHARD = "chr20:1000-101000", 5000
HLA_ALLELES, HLA_REGION_LEN, HLA_COVERAGE = 160, 2000, 30

# The card's memory rate (H100 SXM data sheet) and int32 operations per
# SM per clock (Hopper: 16 INT32 lanes in each of 4 SM sub-partitions).
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
# The integer operations the banded DP needs, counted as Hopper integer
# instructions, each taken to issue at INT32_PER_SM_CLOCK, in their fused
# forms where the expression allows (IADD3; the DPX min of three, VIMNMX3,
# and add-then-min, VIADDMNMX, both of which ptxas emits for these
# kernels), and without the work the kernels' loops do but the result
# does not need (register moves, the init-row and exit-row compares of
# every step).  Per pair and step, over the wavefront's 8 rows:
#   even phase, on 8 rows: m1 = min3(m1, i1, d1), 1; the substitution
#     cost (match compare and select, its min with the 'N' cost) added
#     to m1, 4; d1 on rows 1-7 (row 0 is POS_INF):
#     min(d2 + ge, min(m2, i2) + gap-open), a min, an add and an
#     add-then-min, 3; i1 on 8 rows: min(i2 + (ge + npr),
#     m2 + gap-open + npr), a three-input add and an add-then-min, 2:
#     40 + 21 + 16 = 77;
#   odd phase: the same, with d2 on 8 rows and i2 on rows 0-6 (row 7 is
#     POS_INF): 40 + 24 + 14 = 78;
#   the 'N' cost of the step's one new haplotype base, a compare and a
#     select (the other rows keep theirs, shifted): 2.
DP_OPS_PER_STEP = 77 + 78 + 2
# K2 adds, per row and step, the packed label word of both phases (the m1
# field masked; the five others shifted, masked and merged, a shift and a
# LOP3 each: 11) and the six stamps (a LOP3 each), less the 3 + 3 of the
# two rows forced to POS_INF (d1 row 0 and i2 row 7), whose fields and
# stamps are constants.
TB_OPS_PER_STEP = DP_OPS_PER_STEP + 8 * 17 - 6
# Per pair, once: the init row of both phases (16 selects); K1's exit-row
# mins (8 rows x 2 phases) and its final add and shift; K2's exit captures
# (16 selects), its first-strict-minimum over the rows (3 for row 0, 6 for
# each of rows 1-7) and the score's and index's two ops each.
OPS_PER_PAIR = {"band_align": 16 + 16 + 2, "band_align_tb": 16 + 16 + 45 + 4}
# Clock cycles a sleep kernel holds the stream before a timed run (about
# 0.27 s at 1980 MHz), so the host queues every timed launch meanwhile.
HOLD_CYCLES = 1 << 29

# A sitecustomize.py for the port's fresh interpreters: `import
# platypus_tpu` and `import jax` raise there and in every process they
# spawn (spawned children load sitecustomize from PYTHONPATH too).
BLOCKER = """
import importlib.abc
import sys


class _BlockJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("platypus_tpu", "jax"):
            raise ImportError(f"{name} is blocked in the port's processes")
        return None


sys.meta_path.insert(0, _BlockJaxPackage())
"""


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


def cuda_ms(fn, iters, hold=False):
    """Mean milliseconds of fn() on the current stream (CUDA events).  With
    `hold`, a sleep kernel holds the stream while the host queues all
    `iters` calls, so the events time the device alone and not the host's
    launch rate; it raises if the device reached the start event before
    the last call was queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    if hold and start.query():
        raise RuntimeError("cuda_ms: the hold ended before the host queued "
                           "every timed call")
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_kernel(label, name, fn, plain_fn, padded, outputs):
    """Phase 3's times of kernel library `name` on `padded` (TIMED_B pairs
    at TIMED_L2): the device's (launches held, cuda_ms), back to back as
    the host launches them, and the plain version's; with its bound.
    Prints them and returns the report fields."""
    ms = cuda_ms(fn, 20, hold=True)
    host_ms = cuda_ms(fn, 20)
    plain_ms = cuda_ms(plain_fn, 3)
    bound_ms, bound_by = bound(name, padded, outputs)
    print(f"{label}: B={TIMED_B} L2={TIMED_L2}: cuda {ms:.6f} ms on the device "
          f"({TIMED_B / ms * 1e3:.1f} pairs/s), {host_ms:.6f} ms back to back "
          f"from the host; plain torch {plain_ms:.6f} ms "
          f"({TIMED_B / plain_ms * 1e3:.1f} pairs/s); bound {bound_ms:.6f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of it", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def card_rates():
    """(int32 operations per second, bytes per second) of card 0: SMs x
    INT32_PER_SM_CLOCK x its maximum SM clock (nvidia-smi), and
    HBM_BYTES_PER_S."""
    import torch

    mhz = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_PER_SM_CLOCK * float(mhz) * 1e6, HBM_BYTES_PER_S


def needed_ops(name, inputs):
    """The integer operations kernel library `name` needs on these padded
    inputs.  K1 returns only the best exit cell, and row r of pair b exits
    at step read_len_b + r, so the pair needs the steps of read positions
    0..read_len_b on each row: DP_OPS_PER_STEP x (read_len_b + 1).  K2's
    label block covers every step, so each pair needs all of them."""
    n_steps, B = inputs[2].shape
    if name == "band_align":
        steps = int((inputs[4].long() + 1).clamp(max=n_steps).sum())
        return DP_OPS_PER_STEP * steps + OPS_PER_PAIR[name] * B
    return (TB_OPS_PER_STEP * n_steps + OPS_PER_PAIR[name]) * B


def bound(name, inputs, outputs):
    """(bound_ms, bound_by) of kernel library `name` on these padded
    inputs and its outputs: the larger of the bytes it must move (every
    input read once, every output written once) over the memory rate and
    the operations it needs (needed_ops) over the int32 rate."""
    n_bytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    n_ops = needed_ops(name, inputs)
    ops_rate, bytes_rate = card_rates()
    by_bytes, by_ops = n_bytes / bytes_rate * 1e3, n_ops / ops_rate * 1e3
    print(f"bound: {name}: {n_ops} integer operations ({by_ops:.6f} ms at "
          f"{ops_rate / 1e12:.3f} Tops/s), {n_bytes} bytes ({by_bytes:.6f} ms "
          f"at {bytes_rate / 1e12:.2f} TB/s)", flush=True)
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sass_loop(name):
    """Print the opcodes of the longest loop in kernel library `name`'s
    SASS (`cuobjdump -sass`), per step of the DP (4 loads each), beside
    the DP_OPS_PER_STEP / TB_OPS_PER_STEP that bound() counts."""
    import collections
    import re
    import shutil

    from platypus_tpu_torch.ops import align_cuda

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.run([tool, "-sass", align_cuda.library_path(name)],
                          capture_output=True, text=True)
    insts = [(int(m.group(1), 16), m.group(2)) for m in
             re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", proc.stdout)]
    loops = []
    for addr, text in insts:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    if proc.returncode != 0 or not loops:
        print(f"sass: {name}: not measured (cuobjdump exited "
              f"{proc.returncode}, {len(loops)} loops)", flush=True)
        return
    start, end = max(loops, key=lambda span: span[1] - span[0])
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
                              .split(".")[0]
                              for addr, text in insts if start <= addr <= end)
    steps = ops["LDG"] / 4 or 1
    counted = DP_OPS_PER_STEP if name == "band_align" else TB_OPS_PER_STEP
    alu = sum(n for op, n in ops.items()
              if op not in ("LDG", "STG", "BRA", "NOP"))
    print(f"sass: {name}: loop body {sum(ops.values())} instructions over "
          f"{steps:g} steps, {alu / steps:.1f} non-memory per step against "
          f"{counted} counted by bound(); "
          + ", ".join(f"{op} {n}" for op, n in ops.most_common()), flush=True)


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
    return dict(max_abs_err=max_err, **time_kernel(
        "kernel", "band_align",
        lambda: align_cuda.band_align_padded(*padded),
        lambda: align_torch.band_align_padded_reference(*padded), padded,
        [align_cuda.band_align_padded(*padded)]))


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
    return dict(max_abs_err=max_err, **time_kernel(
        "kernel K2", "band_align_tb",
        lambda: align_cuda.band_align_traceback_padded(*padded),
        lambda: align_torch.band_align_traceback_padded_reference(*padded),
        padded, align_cuda.band_align_traceback_padded(*padded)))


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


def port_env(**extra):
    """The environment of the port's fresh interpreters: this one's, with
    BLOCKER's directory first on PYTHONPATH (the repository after it) and
    `extra` laid over it."""
    site = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                        "blocker")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as fh:
        fh.write(BLOCKER)
    return dict(os.environ, PYTHONPATH=os.pathsep.join([site, REPO]), **extra)


def run_cli(package, argv, env=None, cwd=REPO):
    """`python -m <package>.cli <argv>` in a fresh interpreter in `cwd`;
    returns its wall seconds (interpreter start and imports included)."""
    cmd = [sys.executable, "-m", f"{package}.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{package} CLI failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return wall


def run_port_cli(argv, out, checkout=None, **env):
    """The port's CLI on cuda in a fresh interpreter under BLOCKER, `env`
    laid over its environment; fails on any ERROR line of its log
    (`out`.log).  With `checkout`, that checkout's port instead, with only
    it on PYTHONPATH and no blocker.  Returns its wall seconds."""
    if checkout is None:
        wall = run_cli("platypus_tpu_torch", argv, env=port_env(**env))
    else:
        wall = run_cli("platypus_tpu_torch", argv, cwd=checkout,
                       env=dict(os.environ, PYTHONPATH=checkout, **env))
    with open(f"{out}.log") as fh:
        errors = [line for line in fh if " - ERROR - " in line
                  or " - CRITICAL - " in line]
    if errors:
        raise RuntimeError("port CLI logged ERROR records:\n" + "".join(errors))
    return wall


# The JAX package pinned to the CPU.  PLATYPUS_TPU_DEVICE_FLANK=0 keeps its
# --calculateFlankScore path from importing jax, which this host may not have.
REFERENCE_ENV = dict(PLATYPUS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                     PLATYPUS_TPU_DEVICE_FLANK="0")


def run_reference(argv):
    """The JAX package's CLI pinned to the CPU, in a fresh interpreter;
    returns its wall seconds."""
    return run_cli("platypus_tpu", [argv[0], "--deviceInference=0", *argv[1:]],
                   env=dict(os.environ, **REFERENCE_ENV))


def pool_summary(out):
    """The port pool's summary line (engine/runner.py run_pool) from its
    log, `out`.log: claim counts (host, device, rescued), whether the
    device worker was terminated, and the device worker's own counts
    (regions, launches per kernel library, fused-inference batches)."""
    with open(f"{out}.log") as fh:
        lines = [line for line in fh if " - pool: " in line]
    if not lines:
        raise AssertionError(f"no pool summary in {out}.log")
    return json.loads(lines[-1].split(" - pool: ", 1)[1])


def check_pool(info, region, smi):
    """Phase 8: the slice through the port's pool and the reference's,
    both at --nCPU=4, against the single-process reference lines."""
    workdir = info["workdir"]
    extra = ("--nCPU=4",)
    out = os.path.join(workdir, "port_pool.vcf")
    wall = run_port_cli(cli_args(info, region, out, extra), out)
    summary = pool_summary(out)
    ref_out = os.path.join(workdir, "reference_pool.vcf")
    ref_wall = run_reference(cli_args(info, region, ref_out, extra))
    n_lines = check_same_calls("pool", os.path.join(workdir, "reference.vcf"),
                               out, ref_out)
    if summary["host"] + summary["device"] + summary["rescued"] <= 0:
        raise AssertionError(f"pool: no region claimed: {summary}")
    print(f"pool: --nCPU=4 on {smi}: port CLI {wall:.6f} s, CPU-pinned "
          f"reference CLI {ref_wall:.6f} s; port claims host "
          f"{summary['host']} / device {summary['device']} / rescued "
          f"{summary['rescued']}; the device worker called "
          f"{summary['regions']} regions ({summary['band_align']} K1 launches) "
          f"and was terminated {summary['terminated']} times; "
          f"{n_lines} VCF data lines byte-identical to each other and to "
          f"the single-process reference", flush=True)


def check_hybrid(info, smi):
    """Phase 9: the device worker must call flank regions through K2 while
    the host workers take the scalar flank path."""
    workdir = info["workdir"]
    shard = f"--bufferSize={HYBRID_SHARD}"
    out = os.path.join(workdir, "port_hybrid.vcf")
    wall = run_port_cli(
        cli_args(info, HYBRID_REGION, out, ("--calculateFlankScore=1", shard,
                                            "--nCPU=2", "--tpuWorkers=1")),
        out, PLATYPUS_TPU_DEVICE_SETTLE="0")
    summary = pool_summary(out)
    if summary["regions"] < 1 or summary["band_align_tb"] < 1:
        raise AssertionError(f"hybrid: the device worker called no region "
                             f"through K2: {summary}")
    ref_out = os.path.join(workdir, "reference_hybrid.vcf")
    ref_wall = run_reference(cli_args(info, HYBRID_REGION, ref_out,
                                      ("--calculateFlankScore=1", shard,
                                       "--nCPU=4")))
    n_lines = check_same_calls("hybrid", ref_out, out)
    print(f"hybrid: {HYBRID_REGION} --calculateFlankScore=1 {shard} on {smi}: "
          f"port CLI --nCPU=2 --tpuWorkers=1 {wall:.6f} s (claims host "
          f"{summary['host']} / device {summary['device']} / rescued "
          f"{summary['rescued']}; the device worker called "
          f"{summary['regions']} regions with {summary['band_align_tb']} K2 and "
          f"{summary['band_align']} K1 launches); CPU-pinned reference CLI "
          f"--nCPU=4 {ref_wall:.6f} s; {n_lines} VCF data lines "
          f"byte-identical", flush=True)


def check_service(info, region, smi):
    """Phase 10: two host workers whose fused inference the device-owner
    service runs on the card."""
    workdir = info["workdir"]
    out = os.path.join(workdir, "port_service.vcf")
    stats_path = os.path.join(workdir, "service_stats.json")
    if os.path.exists(stats_path):
        os.remove(stats_path)
    wall = run_port_cli(
        cli_args(info, region, out, ("--nCPU=2", "--tpuWorkers=0",
                                     "--inferenceService=1")), out,
        PLATYPUS_TPU_SERVICE_WAIT_READY="120", PLATYPUS_TPU_SERVICE_GRACE="60",
        PLATYPUS_TPU_SERVICE_STATS=stats_path)
    with open(stats_path) as fh:
        stats = json.load(fh)
    if (stats["backend"] != "cuda" or stats["requests"] <= 0
            or stats["windows"] <= 0 or stats["errors"] != 0):
        raise AssertionError(f"service: served nothing on the card: {stats}")
    n_lines = check_same_calls("service", os.path.join(workdir, "reference.vcf"),
                               out)
    print(f"service: --nCPU=2 --inferenceService=1 on {smi}: port CLI "
          f"{wall:.6f} s, {stats['requests']} requests, {stats['windows']} "
          f"windows served, {stats['errors']} errors; {n_lines} VCF data "
          f"lines byte-identical", flush=True)


def check_resume(info, smi):
    """Phase 11: continueCalling on the single-process slice output cut
    after its middle data line, through the port and the reference."""
    workdir = info["workdir"]
    full = os.path.join(workdir, "port.vcf")
    with open(full) as fh:
        lines = fh.readlines()
    data = [i for i, line in enumerate(lines) if not line.startswith("#")]
    cut = lines[: data[len(data) // 2] + 1]
    done = {}
    for who in ("port", "reference"):
        partial = os.path.join(workdir, f"resume_{who}.vcf")
        with open(partial, "w") as fh:
            fh.writelines(cut)
        argv = ["continueCalling", f"--vcfFile={partial}"]
        if who == "port":
            wall = run_port_cli(argv, full)
        else:
            wall = run_cli("platypus_tpu", argv,
                           env=dict(os.environ, **REFERENCE_ENV))
        with open(os.path.join(workdir, f"resume_{who}_ContinuedFromFailed"
                                        f"Process.vcf")) as fh:
            done[who] = (wall, fh.read())
    if done["port"][1] != done["reference"][1]:
        raise AssertionError("resume: the port's continuation differs from "
                             "the reference's")
    resumed = [line for line in done["port"][1].splitlines(True)
               if not line.startswith("#")]
    if resumed != data_lines(full):
        raise AssertionError("resume: the continuation's data lines differ "
                             "from the full run's")
    print(f"resume: cut after data line {len(data) // 2 + 1} of {len(data)}; "
          f"continueCalling on {smi}: port CLI {done['port'][0]:.6f} s, "
          f"CPU-pinned reference CLI {done['reference'][0]:.6f} s; "
          f"continuations byte-identical, {len(resumed)} data lines equal "
          f"to the full run's", flush=True)


# A fresh interpreter running the port's CLI on cuda, which prints its
# kernel launch counts (counted from zero at its start) as its last line.
COUNTED_CLI = ("import json, sys\n"
               "from platypus_tpu_torch import cli\n"
               "from platypus_tpu_torch.ops import align_cuda\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print('LAUNCHES ' + json.dumps(align_cuda.LAUNCHES), flush=True)\n"
               "sys.exit(rc)\n")


def counted_result(proc, log):
    """(launches, stdout) of a finished COUNTED_CLI process; fails on a
    non-zero exit or an ERROR line in its log file `log`."""
    if proc.returncode != 0:
        raise RuntimeError(f"port CLI failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    with open(log) as fh:
        errors = [line for line in fh if " - ERROR - " in line
                  or " - CRITICAL - " in line]
    if errors:
        raise RuntimeError("port CLI logged ERROR records:\n" + "".join(errors))
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("LAUNCHES ")]
    return json.loads(lines[-1].split(" ", 1)[1]), proc.stdout


def check_mesh_cli(info, region, smi):
    """Phase 12: --meshDevices=-1 through the port's CLI, on the slice and
    (flank scores) on FLANK_REGION, against the reference's default runs."""
    workdir = info["workdir"]
    env = port_env(PLATYPUS_TPU_MESH_TIMERS="1")
    for name, reg, extra, ref_name, kernel in (
            ("mesh", region, (), "reference.vcf", "band_align"),
            ("mesh_flank", FLANK_REGION, ("--calculateFlankScore=1",),
             "reference_flank_region.vcf", "band_align_tb")):
        out = os.path.join(workdir, f"port_{name}.vcf")
        argv = cli_args(info, reg, out, ("--meshDevices=-1", *extra))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COUNTED_CLI, *argv],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        launches, stdout = counted_result(proc, f"{out}.log")
        timers = [line for line in stdout.splitlines()
                  if line.startswith("[mesh] ")]
        n_lines = check_same_calls(name, os.path.join(workdir, ref_name), out)
        if launches[kernel] <= 0 or not any("pack+launch" in t for t in timers):
            raise AssertionError(f"{name}: no {kernel} launch or no [mesh] "
                                 f"timers: {launches}, {timers[:3]}")
        print(f"mesh: {reg} {' '.join(extra)} --meshDevices=-1 on {smi}: port "
              f"CLI {wall:.6f} s, {launches['band_align']} K1 and "
              f"{launches['band_align_tb']} K2 launches, [mesh] timers summed "
              f"over {len(timers) // 3} regions: {mesh_timer_sums(timers)}; "
              f"{n_lines} VCF data lines byte-identical to the reference's "
              f"default run", flush=True)


def mesh_timer_sums(timers):
    """Seconds per [mesh] timer (pack+launch, device_get, unpack), summed
    over the lines `[mesh] <name>[ N groups]: <t>s`."""
    sums = {}
    for line in timers:
        label, value = line[len("[mesh] "):].rsplit(": ", 1)
        name = label.split(" ")[0]
        sums[name] = round(sums.get(name, 0.0) + float(value.rstrip("s")), 6)
    return sums


def span(region):
    """'chrom:start-end' -> (chrom, start, end)."""
    chrom, bounds = region.split(":")
    start, end = bounds.split("-")
    return chrom, int(start), int(end)


def check_mesh_shards(info, region, smi, device):
    """Phase 13: mesh_call_region on 1 shard, 2 shards of `device` and,
    with two cards or more, every card: pair scores and calls identical."""
    import torch

    from platypus_tpu_torch import graft_entry
    from platypus_tpu_torch.cli import build_config
    from platypus_tpu_torch.parallel import mesh

    meshes = [mesh.make_mesh(devices=[device]),
              mesh.make_mesh(devices=[device, device])]
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        meshes.append(mesh.make_mesh())
    chrom, start, _end = span(region)
    for reg, extra in (((chrom, start, start + 100000), ()),
                       (span(FLANK_REGION), ("--calculateFlankScore=1",))):
        config = build_config([f"--bamFiles={info['bam']}",
                               f"--refFile={info['ref']}", "--meshDevices=2",
                               *extra, "-o", "-"])
        reset_counts()
        t0 = time.perf_counter()
        counts = graft_entry.check_mesh_region(config, reg, device, meshes)
        wall = time.perf_counter() - t0
        launched = read_counts()
        kernel = "band_align_tb" if extra else "band_align"
        if launched[kernel] <= 0:
            raise AssertionError(f"mesh shards: no {kernel} launch: {launched}")
        print(f"mesh shards: {reg} {' '.join(extra)} on {smi}: "
              f"{[m.shape for m in meshes]} gave bitwise equal pair scores "
              f"({counts['pairs']} pairs, {counts['windows']} windows) and "
              f"identical calls ({counts['calls']}), also with the host path; "
              f"{launched[kernel]} {kernel} launches; {wall:.6f} s", flush=True)


def check_dryrun(smi, device):
    """Phase 14: graft_entry.dryrun_multichip on every card of `device`'s
    type, and the demo step on 2 shards of `device` against 1 shard."""
    import numpy as np
    import torch

    from platypus_tpu_torch import graft_entry
    from platypus_tpu_torch.parallel import mesh

    n = torch.cuda.device_count() if device.type == "cuda" else 1
    t0 = time.perf_counter()
    counts = graft_entry.dryrun_multichip(n, device.type)
    wall = time.perf_counter() - t0
    batch = mesh.make_example_batch(W=8, Rmax=16)
    one = mesh.build_calling_step(mesh.make_mesh(devices=[device]))(*batch)
    two = mesh.build_calling_step(mesh.make_mesh(devices=[device] * 2))(*batch)
    if not np.array_equal(one[2], two[2]):
        raise AssertionError("demo step: scores differ between 1 and 2 shards")
    freq_err = float(np.abs(one[0] - two[0]).max())
    ratio_err = float(np.abs(one[1] - two[1]).max())
    if freq_err > 1e-5 or ratio_err > 1e-3:
        raise AssertionError(f"demo step: 2 shards differ from 1 by "
                             f"{freq_err} (freq), {ratio_err} (ratio)")
    print(f"dry run: dryrun_multichip({n}, {device.type}) on {smi} in "
          f"{wall:.6f} s: {counts}; demo step on 2 shards of {device}: scores "
          f"bitwise equal "
          f"to 1 shard, max |freq diff| {freq_err}, max |ratio diff| "
          f"{ratio_err}", flush=True)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_distributed(info, region, smi):
    """Phase 15: two --distributed=1 processes (torchrun's environment,
    gloo) over the slice; the merged VCF equals the reference's."""
    workdir = info["workdir"]
    out = os.path.join(workdir, "port_distributed.vcf")
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            argv = cli_args(info, region, out, ("--distributed=1",))
            argv[argv.index(f"--logFileName={out}.log")] = \
                f"--logFileName={out}.{rank}.log"
            env = port_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE="2", RANK=str(rank),
                           LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", COUNTED_CLI, *argv], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = []
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=600)
            results.append(counted_result(
                subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                            stderr), f"{out}.{rank}.log")[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    wall = time.perf_counter() - t0
    n_lines = check_same_calls("distributed",
                               os.path.join(workdir, "reference.vcf"), out)
    if any(r["band_align"] <= 0 for r in results):
        raise AssertionError(f"distributed: a rank launched no K1: {results}")
    print(f"distributed: two --distributed=1 processes (gloo) on {smi}: "
          f"{wall:.6f} s, K1 launches per rank "
          f"{[r['band_align'] for r in results]}; {n_lines} merged VCF data "
          f"lines byte-identical to the reference", flush=True)


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


def compare_walls(other, pairs, smi):
    """--walls-against: fresh slice CLIs of checkout `other` and of this
    one, each warmed once, then `pairs` timed pairs in alternating order
    (other, this, this, other, ...); every run's data lines equal the
    first's.  Prints each wall, then a JSON summary as the last line."""
    workdir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                           f"mb{SLICE_MB:g}")
    info = build_dataset("slice", workdir, SLICE_MB)
    region = f"chr20:1000-{info['length'] + 1000}"
    checkouts = {"other": os.path.abspath(other), "this": None}
    walls = {name: [] for name in checkouts}
    want = None
    for k in range(-1, pairs):
        order = list(checkouts) if k % 2 == 0 else list(checkouts)[::-1]
        for name in order:
            out = os.path.join(workdir, f"walls_{name}_{k}.vcf")
            wall = run_port_cli(cli_args(info, region, out), out,
                                checkout=checkouts[name])
            want = want or data_lines(out)
            if data_lines(out) != want:
                raise AssertionError(f"walls: {name} run {k}: data lines differ")
            if k >= 0:
                walls[name].append(wall)
            print(f"walls: {'warm-up' if k < 0 else f'pair {k}'} {name}: "
                  f"{wall:.6f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"lines": len(want), "card": smi, "other": other, **{
        name: {"walls": w, "median": statistics.median(w)}
        for name, w in walls.items()}}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--walls-against", metavar="OTHER_CHECKOUT")
    parser.add_argument("--pairs", type=int, default=4)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from platypus_tpu_torch import native
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
    if args.walls_against:
        return compare_walls(args.walls_against, args.pairs, smi)

    # 2. build: one nvcc per kernel source and the native host library,
    # all started together
    t0 = time.perf_counter()

    def timed(fn, *args):
        start = time.perf_counter()
        fn(*args)
        return time.perf_counter() - start

    with ThreadPoolExecutor(len(align_cuda.KERNELS) + 1) as pool:
        native_s = pool.submit(timed, native.build)
        list(pool.map(align_cuda.build, align_cuda.KERNELS))
        native_s = native_s.result()
    for name in align_cuda.KERNELS:
        align_cuda.load(name)
    lib = native.load()
    if lib is None or lib._name != native.library_path():
        raise RuntimeError(f"the port's native library did not build: {lib}")
    print(f"build: {', '.join(align_cuda.KERNELS)} kernels and the native "
          f"library in {time.perf_counter() - t0:.3f} s (native {native_s:.3f} s)",
          flush=True)
    print(f"native: the port loaded {lib._name}", flush=True)
    for name in align_cuda.KERNELS:
        for line in align_cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: ptxas: {line.strip()}", flush=True)
        sass_loop(name)

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

    # 8-11. the multi-process run and continueCalling, each in fresh
    # interpreters (this process holds a CUDA context)
    check_pool(info, region, smi)
    check_hybrid(info, smi)
    check_service(info, region, smi)
    check_resume(info, smi)
    errors.check("pool, hybrid, service, resume")

    # 12-15. the mesh and the multi-host run
    check_mesh_cli(info, region, smi)
    check_mesh_shards(info, region, smi, torch.device("cuda", 0))
    check_dryrun(smi, torch.device("cuda", 0))
    check_distributed(info, region, smi)
    errors.check("mesh, dry run, distributed")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "platypus_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

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
