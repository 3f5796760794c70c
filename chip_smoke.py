#!/usr/bin/env python3
"""On-card smoke test of the torch port (platypus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
without either it exits non-zero before printing any result.  Every port
CLI that runs in a fresh interpreter does so under a sitecustomize.py
(BLOCKER) that makes `import platypus_tpu` and `import jax` raise, in
that process and in every process it spawns; the port imports nothing of
the JAX package.  Phases (numbered as the failure messages name them;
there is no phase 16):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel library of align_cuda.KERNELS -- K1, the
   banded-alignment DP (csrc/band_align.cu: its pair entry, which gathers
   and pads its pairs from the deduplicated matrices, and its padded
   entry), K2, its traceback mode (csrc/band_align_tb.cu: one pair
   entry, the same gather and pad, 16-bit label words; both include
   csrc/pair_loader.cuh), and the fused window inference
   (csrc/infer_window.cu: GL/GOF, EM and posteriors; one kernel a batch
   on the warp route, two on the CTA routes) --
   one nvcc each for sm_90a, and the port's
   native host library (platypus_tpu_torch/native/src, g++), all started
   together; prints the native library's path, ptxas's registers and
   spills, and for each DP kernel function the longest straight-line run
   of its SASS (cuobjdump: each kernel's block of 4 steps), beside the
   operations bound() counts;
3. kernel: each CUDA kernel bitwise against its plain torch version on
   the card -- every reference golden (K2: the flank goldens, whose
   alignments the host backtrace must reproduce from K2's label words;
   the pair entries: through identity indices), main-path shapes (B =
   16384, 2048 and 2000 pairs at read lengths 100 and 128, mixed
   lengths, 'N' bases) and, for the pair entries, overhanging segments
   and B = 1, 127 and 2047 (K2 also a batch of tied exit cells:
   tie_pairs) -- then timed with CUDA events at L2=100 (the pair
   entries at B=16384 and 2048, K1's padded entry at 16384; on the
   device alone, its launches queued behind a sleep kernel, and back to
   back as the host launches them) against its plain version, with its
   bound: the larger of the bytes it must move over the card's memory
   rate and its int32 operations over the card's int32 rate (bound());
   the fused inference against its plain torch version
   (likelihood_torch.infer_window_batch) on INFER_SHAPES (batches whose
   em_path is each route: warp, shared, and global past 227 KB), each on
   every route that fits it, within the tolerances of
   tests/test_torch_likelihood.py (compare_inference: em, freq and
   ratios skip guard-band windows, which it counts), two launches bitwise
   equal, then timed per route: the kernel on the device alone and back
   to back, the plain version back to back;
4. slice: `platypus_tpu_torch.cli.main(["callVariants", ...])` on cuda
   over a synthetic 1 Mb, 30x, 100 bp dataset (ten 100 kb regions; built
   by tests/test_torch_smoke_data.py in a child process, as is the HLA
   panel, since their writers belong to the JAX package), with
   counters showing K1 and the fused inference kernel ran (and its plain
   version never did), the sizes of its K1 launches and the windows the
   f64 guard sent to the host (device_windows_to_host).  Every fused
   inference batch it launched is kept (InferRecorder): the kernel
   against its plain version on each, then each timed (kernel on the
   device alone, plain back to back) with its route, beside the bound
   over the EM iterations each window ran (infer_bound) and the chain
   floor (the slowest window's iterations of each batch times the warp
   route's measured latency of one iteration).  The largest K1 chunk of its first region is kept
   (the engine's matrices and index vectors): the pair entry bitwise on
   it, then the old route (the chunk padded to its lane bucket,
   gather/pad and the padded entry) and the new (the pair entry on
   exactly its pairs) timed in turns on the device; then one more
   100 kb region with --maxHaplotypes=4 so the beam search aligns through
   K1 too;
5. reference: the JAX package's CLI pinned to the CPU (native kernels,
   float64 inference, no jax import) on the same data; the port's VCF
   data lines must be byte-identical to it in both runs.  For a like for
   like time, the port's CLI also runs in a fresh interpreter, as the
   reference does: both walls include interpreter start and imports;
   then the slice once more with launch_fused_inference pointed at the
   plain version (in this script only), byte-identical too, which prints
   its device_windows_to_host beside the kernel's;
6. flank: the whole slice again with --calculateFlankScore=1, which must
   launch K2 and lower some pair scores by the flank penalty; its K2
   launch sizes are recorded and its first region's largest K2 chunk is
   kept: K2 bitwise on it against its plain version, then timed on the
   device alone with its bound; then
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
   K2: the device worker must call regions and launch K2 and the fused
   inference kernel there (its own
   counts, reported back through the pool's summary line), and the lines
   must equal the CPU-pinned reference's;
10. service: --nCPU=2 --tpuWorkers=0 --inferenceService=1 on the slice:
   the device-owner service must serve windows with no error through the
   fused inference kernel (its stats count the launches), and the
   lines must equal the single-process reference's;
11. resume: the single-process slice output cut after its middle data
   line, continued by `continueCalling` through the port's CLI and the
   CPU-pinned reference's: both continuations byte-identical, their data
   lines those of the full run;
12. mesh CLI: the slice, and FLANK_REGION with --calculateFlankScore=1,
   each with --meshDevices=-1 through the port's CLI in a fresh
   interpreter that reports its kernel launches: byte-identical to the
   reference's default runs, with K1 (K2) and the fused inference kernel
   launched and the mesh spans (mesh_pack_launch, mesh_fetch, mesh_unpack)
   timed;
13. mesh shards: in this process, mesh_call_region over a slice region
   and over FLANK_REGION in flank mode on a 1-shard mesh, a 2-shard mesh
   on cuda:0 and, with two cards or more, a mesh of every card: pair
   scores bitwise equal and calls identical to each other and to the
   float64 host path (graft_entry.check_mesh_region);
14. dry run: graft_entry.dryrun_multichip on every card, and the demo
   step on a 2-shard mesh of cuda:0 against a 1-shard one;
15. distributed: --distributed=1 as two fresh processes under torchrun's
   environment (gloo; rank r on cuda:{r % cards}) over the slice, merged
   byte-identical to the reference;
17. trace: one 100 kb region of the slice in this process inside
   observability.trace("slice_region") with PLATYPUS_TPU_TRACE_DIR set,
   byte-identical to the reference on that region; the *.pt.trace.json it
   wrote must hold GPU kernel events, K1's and the fused inference's
   among them; prints the traced
   window, the device-busy time (the union of kernel, memcpy and memset
   intervals) and idle share, the kernel count, the host time in the
   kernel-launch calls and the top 10 device ops;
18. cohort: tools/cohort_bench.py's cohort (one BAM per sample, common
   SNPs at drawn frequencies, one private SNP each; 0.2 Mb at 6x a
   sample, built in a child process) at 16 samples (I = 16: the card's
   inference feeds the VCF) and 30 (the f64 guard sends every window to
   the host): the port on cuda in this process, the CPU-pinned
   reference and the port with launch_fused_inference pointed at the
   plain version, byte-identical; device_windows_to_host of both routes;
   every fused-inference batch (W, Hb, Rb, I, Vb) checked against the
   plain version and timed with its route and EM iterations; at 30
   samples the K3 time spent on results the guard threw away.

Any ERROR record on the `platypus_tpu` logger fails the run (every
crash-containment path logs there), and so does a module of the JAX
package in this process's sys.modules at the end.  A failure prints, on
stderr, the phase, the last command the phase ran (its exit code and the
tail of its stderr) and the error, and the script exits non-zero.  The
last two lines of stdout are the kernel report and {"ok": true,
"device": {...}}.

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
import contextlib
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
# Phase 18's cohorts (tools/cohort_bench.py build_cohort): samples, bp of
# chr20, coverage per sample.  16 samples keep the device's inference in
# the VCF; past 25 the f64 guard sends every window to the host.
COHORT_SAMPLES, COHORT_LENGTH, COHORT_COVERAGE = (16, 30), 200_000, 6

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
# K2 adds, per row and step, the packed 16-bit label word of both phases
# and the six stamps (a LOP3 each).  The word takes the M field of the
# even phase as it stands and the five fields above it each shifted into
# place and merged under a mask, a shift and a LOP3 each: 10 (the mask of
# the M field is the first merge's).  Less 2 + 2 for the two rows forced
# to POS_INF (d1 row 0 and i2 row 7), whose shifts and stamps are
# constants (their merges stay): 8 * 16 - 4 = 124.
TB_OPS_PER_STEP = DP_OPS_PER_STEP + 8 * 16 - 4
# Per pair, once: the init row of both phases (16 selects); K1's exit-row
# mins (8 rows x 2 phases) and its final add and shift; K2's exit captures
# (16 selects), its first strict minimum over them (3 for row 0, 6 for
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


# The running phase of main() and the last child process it started:
# (command, finished process or None while it runs); failure_report prints
# both when the script fails.
PHASE, LAST_CHILD = [], []


def run_child(cmd, **kwargs):
    """subprocess.run(cmd) with its output captured as text, recorded as
    the phase's last child."""
    LAST_CHILD[:] = [cmd, None]
    proc = subprocess.run(cmd, capture_output=True, text=True, **kwargs)
    LAST_CHILD[1] = proc
    return proc


def start_phase(label):
    """Marks the start of one phase of main() (for failure_report)."""
    PHASE[:] = [label]
    LAST_CHILD.clear()


def failure_report(exc):
    """On stderr: the phase that failed, the last command it ran (with its
    exit code and the tail of its stderr) and the error."""
    label = PHASE[0] if PHASE else "before phase 1"
    print(f"chip_smoke: phase {label} failed: {type(exc).__name__}: "
          f"{str(exc)[-2000:]}", file=sys.stderr, flush=True)
    if not LAST_CHILD:
        print(f"chip_smoke: phase {label}: no command ran in this phase",
              file=sys.stderr, flush=True)
        return
    cmd, proc = LAST_CHILD
    shown = " ".join(str(c) for c in cmd)[:1000]
    if proc is None:
        print(f"chip_smoke: phase {label}: last command (did not finish): "
              f"{shown}", file=sys.stderr, flush=True)
    else:
        print(f"chip_smoke: phase {label}: last command (exit "
              f"{proc.returncode}): {shown}\nits stderr tail:\n"
              f"{(proc.stderr or '')[-4000:]}", file=sys.stderr, flush=True)


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


def tie_pairs(seed, B, L2):
    """Homopolymer pairs whose exit cells tie: reads of 'A' against haps of
    'A' behind 0-11 'C's, so the best score recurs on several rows and in
    both phases, and the first strict minimum falls on every row and
    phase across the batch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hap = np.full((B, L2 + 15), ord("A"), np.int32)
    hap[np.arange(L2 + 15)[None, :] < rng.integers(0, 12, B)[:, None]] = ord("C")
    go = np.full((B, L2 + 15), 40, np.int32)
    read = np.full((B, L2), ord("A"), np.int32)
    qual = np.full((B, L2), 30, np.int32)
    rl = rng.integers(L2 // 2, L2 + 1, B).astype(np.int32)
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


def time_kernel(label, name, fn, plain_fn, read_len, n_steps, n_bytes):
    """Phase 3's times of kernel library `name` through `fn` (pairs with
    [B] read_len, n_steps = L2 + 8 steps, n_bytes to move): the device's
    (launches held, cuda_ms), back to back as the host launches them, and
    the plain version's; with its bound.  Prints them and returns the
    report fields."""
    B = len(read_len)
    ms = cuda_ms(fn, 20, hold=True)
    host_ms = cuda_ms(fn, 20)
    plain_ms = cuda_ms(plain_fn, 3)
    bound_ms, bound_by = bound(name, read_len, n_steps, n_bytes)
    print(f"{label}: B={B} L2={n_steps - 8}: cuda {ms:.6f} ms on the device "
          f"({B / ms * 1e3:.1f} pairs/s), {host_ms:.6f} ms back to back "
          f"from the host; plain torch {plain_ms:.6f} ms "
          f"({B / plain_ms * 1e3:.1f} pairs/s); bound {bound_ms:.6f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of it", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pair_bytes(mats, index):
    """Bytes K1's pair entry must move on these inputs: each matrix byte a
    pair touches, read once (pairs share rows), the four int32 index rows
    and the int32 output.  A pair touches hap and gap-open columns ps ..
    ps + read_len + 14 (clamped to the width) and read and quality
    columns 0 .. read_len - 1."""
    import numpy as np

    H, L1B = mats[0].shape
    A, L2 = mats[2].shape
    ph, pr, ps, rl = (t.cpu().numpy().astype(np.int64) for t in index)
    hap_touched = np.zeros((H, L1B + 1), np.int32)
    lo = np.minimum(ps, L1B - 1)
    hi = np.minimum(ps + rl + 15, L1B)
    np.add.at(hap_touched, (ph, lo), 1)
    np.add.at(hap_touched, (ph, hi), -1)
    seq_touched = np.zeros((A, L2 + 1), np.int32)
    np.add.at(seq_touched, (pr, 0), 1)
    np.add.at(seq_touched, (pr, np.clip(rl, 0, L2)), -1)
    n_hap = int((np.cumsum(hap_touched, axis=1)[:, :L1B] > 0).sum())
    n_seq = int((np.cumsum(seq_touched, axis=1)[:, :L2] > 0).sum())
    return 2 * n_hap + 2 * n_seq + 5 * 4 * len(rl)


def card_rates():
    """(int32 operations per second, bytes per second) of card 0: SMs x
    INT32_PER_SM_CLOCK x its maximum SM clock (nvidia-smi), and
    HBM_BYTES_PER_S."""
    import torch

    mhz = run_child(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"], check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_PER_SM_CLOCK * float(mhz) * 1e6, HBM_BYTES_PER_S


def needed_ops(name, read_len, n_steps):
    """The integer operations kernel library `name` needs on pairs of
    these [B] read lengths, n_steps = L2 + 8 steps.  K1 (either entry)
    returns only the best exit cell, and row r of pair b exits at step
    read_len_b + r, so the pair needs the steps of read positions
    0..read_len_b on each row: DP_OPS_PER_STEP x (read_len_b + 1).  K2's
    label block covers every step, so each pair needs all of them."""
    B = len(read_len)
    if name == "band_align":
        steps = int((read_len.long() + 1).clamp(max=n_steps).sum())
        return DP_OPS_PER_STEP * steps + OPS_PER_PAIR[name] * B
    return (TB_OPS_PER_STEP * n_steps + OPS_PER_PAIR[name]) * B


def bound(name, read_len, n_steps, n_bytes):
    """(bound_ms, bound_by) of kernel library `name` on pairs of these
    read lengths: the larger of the bytes it must move (n_bytes: every
    input read once, every output written once) over the memory rate and
    the operations it needs (needed_ops) over the int32 rate."""
    n_ops = needed_ops(name, read_len, n_steps)
    ops_rate, bytes_rate = card_rates()
    by_bytes, by_ops = n_bytes / bytes_rate * 1e3, n_ops / ops_rate * 1e3
    print(f"bound: {name}: {n_ops} integer operations ({by_ops:.6f} ms at "
          f"{ops_rate / 1e12:.3f} Tops/s), {n_bytes} bytes ({by_bytes:.6f} ms "
          f"at {bytes_rate / 1e12:.2f} TB/s)", flush=True)
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sass_loop(name):
    """Print, for each kernel function in library `name`'s SASS
    (`cuobjdump -sass`), the opcodes of the longest straight-line run (no
    branch, no branch target inside) within a loop: each kernel's block
    of steps without exit captures.  Its steps are its
    VIMNMX3 / 16: every step takes m = min(m, i, d) on 8 rows in each of
    its two phases.  Beside the non-memory instructions per step, the
    DP_OPS_PER_STEP / TB_OPS_PER_STEP that bound() counts."""
    import collections
    import re
    import shutil

    from platypus_tpu_torch.ops import align_cuda

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = run_child([tool, "-sass", align_cuda.library_path(name)])
    sections = re.split(r"\n\s*Function : (\S+)", proc.stdout)
    if proc.returncode != 0 or len(sections) < 3:
        print(f"sass: {name}: not measured (cuobjdump exited "
              f"{proc.returncode})", flush=True)
        return
    counted = DP_OPS_PER_STEP if name == "band_align" else TB_OPS_PER_STEP
    for fname, body in zip(sections[1::2], sections[2::2]):
        insts = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
        ops = [re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
               for _addr, text in insts]
        jumps = [(addr, int(m.group(1), 16)) for addr, text in insts
                 for m in [re.search(r"\b(?:BRA|BSSY|CALL)\b.*?(0x[0-9a-f]+)",
                                     text)] if m]
        targets = {target for _addr, target in jumps}
        loops = [(target, addr) for addr, target in jumps if target <= addr]
        runs, run = [], []
        for (addr, _text), op in zip(insts, ops):
            if addr in targets or op in ("BRA", "EXIT", "RET", "BSSY",
                                         "BSYNC", "CALL"):
                runs.append(run)
                run = []
            if op not in ("BRA", "EXIT", "RET", "BSSY", "BSYNC", "CALL"):
                run.append((addr, op))
        runs.append(run)
        in_loop = [r for r in runs if r and any(lo <= r[0][0] <= hi
                                                for lo, hi in loops)]
        best = collections.Counter(op for _addr, op in
                                   max(in_loop or runs, key=len))
        steps = best["VIMNMX3"] / 16
        if not steps:
            print(f"sass: {name}: {fname}: no VIMNMX3 in the loop's longest "
                  "run; steps per run not measured", flush=True)
            continue
        alu = sum(n for op, n in best.items()
                  if op not in ("LDG", "LDS", "STG", "STS", "NOP"))
        short = re.search(r"(band_align\w*?kernel)", fname)
        print(f"sass: {name}: {short.group(1) if short else fname}: loop's "
              f"longest straight-line run {sum(best.values())} instructions "
              f"over {steps:g} steps, {alu / steps:.1f} non-memory per step "
              f"against {counted} counted by bound(); "
              + ", ".join(f"{op} {n}" for op, n in best.most_common()),
              flush=True)


def pair_inputs(inputs, device, overhang_seed=None, width=None):
    """The padded-style numpy rows of random_pairs / the goldens as K1's
    pair entry's inputs on `device`: one matrix row per pair (identity
    indices), or with `overhang_seed` haps shared by several pairs and a
    third of the segments running past the matrix width.  `width` widens
    the hap and gap-open matrices with 'N' / 0 columns (the engine's
    widths are multiples of 4; the goldens' are not)."""
    import numpy as np
    import torch

    hap, go, read, qual, rl = inputs
    B = len(rl)
    if width is not None:
        hap = np.pad(hap, ((0, 0), (0, width - hap.shape[1])),
                     constant_values=ord("N"))
        go = np.pad(go, ((0, 0), (0, width - go.shape[1])))
    rows = np.arange(B, dtype=np.int32)
    seg = np.zeros(B, np.int32)
    if overhang_seed is not None:
        rng = np.random.default_rng(overhang_seed)
        rows = rng.integers(0, B, B).astype(np.int32)
        seg = rng.integers(0, 8, B).astype(np.int32)
        seg[: B // 3] = hap.shape[1] - rng.integers(1, 40, B // 3)
    mats = [hap.astype(np.uint8), go.astype(np.uint8), read.astype(np.uint8),
            qual.astype(np.uint8)]
    idx = [rows, np.arange(B, dtype=np.int32), seg, rl.astype(np.int32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (*mats, *idx)]


def check_equal(what, got, want):
    """max |got - want| (0 when empty); raises unless it is 0."""
    import torch

    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{what}: kernel != plain version (B="
                             f"{got.numel()}): max |diff| {err}")
    return err


def check_kernel(device):
    """Phase 3 for K1: the padded entry bitwise against the plain DP on
    every golden and the main-path shapes; the pair entry bitwise against
    its plain version (gather/pad + the plain DP) on the goldens through
    identity indices, the main-path shapes, overhanging segments and B =
    1, 127 and 2047, all with mixed read lengths and 'N' bases; then the
    padded entry timed at B=16384 and the pair entry at B=16384 and 2048,
    L2=100.  Returns the pair entry's report fields at B=16384."""
    from platypus_tpu_torch.ops import align_cuda, align_torch

    max_err = 0
    n_pairs = 0
    goldens = [(ge, npr, inputs) for ge, npr, inputs, _ in golden_groups()]
    shapes = [(3, 2, random_pairs(seed, B, L2))
              for seed, (B, L2) in enumerate(MAIN_SHAPES)]
    for k, (ge, npr, inputs) in enumerate(goldens + shapes):
        padded = align_torch.pad_alignment_inputs(*inputs, device=device)
        got = align_cuda.band_align_padded(*padded, gapextend=ge, nucprior=npr)
        want = align_torch.band_align_padded_reference(*padded, gapextend=ge,
                                                       nucprior=npr)
        max_err = max(max_err, check_equal(f"padded entry, case {k}", got, want))
        n_pairs += got.numel()
    print(f"kernel: padded entry bitwise equal to the plain DP on "
          f"{len(goldens) + len(shapes)} batches, {n_pairs} pairs (goldens + "
          f"main-path shapes)", flush=True)

    pair_cases = [(ge, npr, pair_inputs(inputs, device))
                  for ge, npr, inputs in goldens]
    pair_cases += [(ge, npr, pair_inputs(inputs, device,
                                         width=-(-(L2 + 15) // 32) * 32))
                   for (ge, npr, inputs), (_B, L2) in zip(shapes, MAIN_SHAPES)]
    pair_cases += [(3, 2, pair_inputs(random_pairs(40, 2000, 128), device,
                                      overhang_seed=40, width=width))
                   for width in (None, 160)]
    pair_cases += [(3, 2, pair_inputs(random_pairs(50 + B, B, 100), device,
                                      width=128)) for B in (1, 127, 2047)]
    n_pairs = 0
    for k, (ge, npr, args) in enumerate(pair_cases):
        got = align_cuda.band_align_pairs(*args, gapextend=ge, nucprior=npr)
        want = align_torch.band_align_pairs_reference(*args, gapextend=ge,
                                                      nucprior=npr)
        max_err = max(max_err, check_equal(f"pair entry, case {k}", got, want))
        n_pairs += got.numel()
    print(f"kernel: pair entry bitwise equal to gather/pad + the plain DP on "
          f"{len(pair_cases)} batches, {n_pairs} pairs (goldens through "
          f"identity indices, main-path shapes, overhanging segments, B = 1, "
          f"127, 2047)", flush=True)

    padded = align_torch.pad_alignment_inputs(*random_pairs(99, TIMED_B, TIMED_L2),
                                              device=device)
    time_kernel("kernel (padded entry)", "band_align",
                lambda: align_cuda.band_align_padded(*padded),
                lambda: align_torch.band_align_padded_reference(*padded),
                padded[4], TIMED_L2 + 8, tensor_bytes(padded) + 4 * TIMED_B)
    reports = {}
    for B in (TIMED_B, 2048):
        args = pair_inputs(random_pairs(99, B, TIMED_L2), device, width=128)
        reports[B] = time_kernel(
            "kernel (pair entry)", "band_align",
            lambda args=args: align_cuda.band_align_pairs(*args),
            lambda args=args: align_torch.band_align_pairs_reference(*args),
            args[7], TIMED_L2 + 8, pair_bytes(args[:4], args[4:]))
    return dict(max_abs_err=max_err, **reports[TIMED_B])


class ChunkRecorder:
    """While entered: the size of every call of the pair entry `wrapper`
    of align_cuda (K1's band_align_pairs or K2's
    band_align_traceback_pairs), and the inputs of the largest call of the
    first region dispatch that calls it (the engine's own matrices and
    index vectors, kept by reference).  Wraps the wrapper and the region
    pipeline's dispatch_alignment_requests; launches are counted by the
    wrapper inside, as always."""

    def __init__(self, wrapper="band_align_pairs"):
        from platypus_tpu_torch.engine import region
        from platypus_tpu_torch.ops import align_cuda

        self.sizes, self.first = [], None
        self._dispatches, self._first_dispatch = 0, None
        self._region, self._align, self._name = region, align_cuda, wrapper
        self._dispatch = region.dispatch_alignment_requests
        self._pairs = getattr(align_cuda, wrapper)

    def __enter__(self):
        def dispatch(*args, **kwargs):
            self._dispatches += 1
            return self._dispatch(*args, **kwargs)

        def pairs(*args, **kwargs):
            self.sizes.append(len(args[7]))
            if self._first_dispatch is None:
                self._first_dispatch = self._dispatches
            if self._dispatches == self._first_dispatch and (
                    self.first is None or len(args[7]) > len(self.first[7])):
                self.first = args
            return self._pairs(*args, **kwargs)

        self._region.dispatch_alignment_requests = dispatch
        setattr(self._align, self._name, pairs)
        return self

    def __exit__(self, *exc):
        self._region.dispatch_alignment_requests = self._dispatch
        setattr(self._align, self._name, self._pairs)


def check_main_chunk(args, smi):
    """The captured main-path chunk: the pair entry bitwise against its
    plain version, then the old route (the chunk padded to its lane
    bucket with pad pairs, gather/pad, the padded entry) and the new one
    (the pair entry on exactly its pairs) timed in turns (old, new, new,
    old) on the device alone, with the pair entry's bound."""
    import torch

    from platypus_tpu_torch.ops import align_cuda, align_torch

    mats, idx = args[:4], args[4:]
    B, L2 = len(idx[3]), mats[2].shape[1]
    new = align_cuda.band_align_pairs(*args)
    check_equal("main-path chunk", new,
                align_torch.band_align_pairs_reference(*args))
    # The old route padded a chunk (at most 16384 pairs) to the first of
    # the JAX package's lane widths that holds it.
    lane = next(b for b in (2048, 16384) if B <= b)
    pad = [torch.zeros(lane - B, dtype=torch.int32, device=t.device)
           for t in idx]
    pad[3] += min(8, L2)
    old_idx = [torch.cat([t, p]) for t, p in zip(idx, pad)]

    def old_route():
        return align_cuda.band_align_padded(*align_torch.gather_pad(*mats,
                                                                    *old_idx))

    check_equal("main-path chunk, old route", old_route()[:B], new)

    def new_route():
        return align_cuda.band_align_pairs(*args)

    times = [(name, cuda_ms(fn, 20, hold=True)) for name, fn in (
        ("old", old_route), ("new", new_route), ("new", new_route),
        ("old", old_route))]
    host = {name: cuda_ms(fn, 20) for name, fn in (("old", old_route),
                                                    ("new", new_route))}
    bound_ms, bound_by = bound("band_align", idx[3], L2 + 8,
                               pair_bytes(mats, idx))
    new_ms = min(t for name, t in times if name == "new")
    print(f"main-path chunk on {smi}: {B} pairs (L2={L2}, hap matrix "
          f"{tuple(mats[0].shape)}, read matrix {tuple(mats[2].shape)}), "
          f"pair entry bitwise equal to its plain version and to the old "
          f"route; device ms in turns "
          + ", ".join(f"{name} {t:.6f}" for name, t in times)
          + f"; back to back from the host: old {host['old']:.6f}, new "
          f"{host['new']:.6f} ms; old route = gather/pad + padded entry on "
          f"{lane} lanes; pair entry bound {bound_ms:.6f} ms ({bound_by}), "
          f"{bound_ms / new_ms:.1%} of it", flush=True)


def check_flank_chunk(args, smi):
    """The captured flank chunk: K2's pair entry bitwise against its plain
    version on it (score, exit index, labels), then timed on the device
    alone with its bound."""
    from platypus_tpu_torch.ops import align_cuda

    mats, idx = args[:4], args[4:]
    B, L2 = len(idx[3]), mats[2].shape[1]
    check_tb_equal("flank chunk", args)
    ms = min(cuda_ms(lambda: align_cuda.band_align_traceback_pairs(*args), 20,
                     hold=True) for _ in range(2))
    bound_ms, bound_by = bound("band_align_tb", idx[3], L2 + 8,
                               tb_bytes(mats, idx))
    print(f"flank chunk on {smi}: {B} pairs (L2={L2}, hap matrix "
          f"{tuple(mats[0].shape)}, read matrix {tuple(mats[2].shape)}), K2's "
          f"pair entry bitwise equal to its plain version; {ms:.6f} ms on the "
          f"device (least of two runs of 20); bound {bound_ms:.6f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of it", flush=True)


def tb_bytes(mats, index):
    """Bytes K2's pair entry must move on these inputs: pair_bytes (the
    matrix bytes, index rows and the int32 score) plus the int32 exit
    index and the int16 label block [(L2+8)*8, B]."""
    B, L2 = len(index[3]), mats[2].shape[1]
    return pair_bytes(mats, index) + 4 * B + 2 * (L2 + 8) * 8 * B


def check_tb_equal(what, args):
    """K2's pair entry against its plain version on `args`: score, exit
    index and the whole label block bitwise.  Returns (the kernel's
    outputs, max |diff|)."""
    from platypus_tpu_torch.ops import align_cuda, align_torch

    got = align_cuda.band_align_traceback_pairs(*args)
    want = align_torch.band_align_traceback_pairs_reference(*args)
    err = 0
    for name, g, w in zip(("score", "idx", "labels"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} is {g.dtype} {tuple(g.shape)}"
                                 f", its plain version {w.dtype} "
                                 f"{tuple(w.shape)}")
        err = max(err, check_equal(f"{what}: {name}", g, w))
    return got, err


def check_tb_kernel(device):
    """Phase 3 for K2's pair entry: score, exit index and the whole label
    block bitwise equal to its plain version (gather/pad + the plain
    traceback DP) on the flank goldens through identity indices (whose
    alignments and flank scores the host backtrace must then recover from
    the kernel's output), the main-path shapes, overhanging segments, B =
    1, 127 and 2047 and a batch of tied exit cells; then timed at B=16384
    and 2048, L2=100.  Returns the report fields at B=16384."""
    from platypus_tpu_torch.ops import align_cuda, align_torch

    golden_cases, golden_inputs = flank_goldens()
    cases = [("flank goldens", pair_inputs(golden_inputs, device))]
    cases += [(f"B={B} L2={L2}", pair_inputs(
        random_pairs(100 + seed, B, L2), device, width=-(-(L2 + 15) // 32) * 32))
        for seed, (B, L2) in enumerate(MAIN_SHAPES)]
    cases += [(f"overhang, width {width}", pair_inputs(
        random_pairs(41, 2000, 128), device, overhang_seed=41, width=width))
        for width in (None, 160)]
    cases += [(f"B={B}", pair_inputs(random_pairs(60 + B, B, 100), device,
                                     width=128)) for B in (1, 127, 2047)]
    cases += [(f"ties L2={L2}", pair_inputs(tie_pairs(70 + L2, 2000, L2),
                                            device, width=L2 + 28))
              for L2 in (100, 128)]
    n_pairs = max_err = 0
    for what, args in cases:
        got, err = check_tb_equal(f"K2 pair entry, {what}", args)
        max_err = max(max_err, err)
        n_pairs += len(args[7])
        if what == "flank goldens":
            bad = flank_golden_mismatches(golden_cases,
                                          *(t.cpu().numpy() for t in got))
            if bad:
                raise AssertionError(f"K2: flank goldens {bad} not reproduced "
                                     "by the host backtrace")
    print(f"kernel K2: pair entry's score, idx and 16-bit labels bitwise "
          f"equal to gather/pad + the plain traceback DP on {len(cases)} "
          f"batches, {n_pairs} pairs (flank goldens through identity indices, "
          f"main-path shapes, overhanging segments, B = 1, 127, 2047, tied "
          f"exit cells); {len(golden_cases)} flank goldens' alignments and "
          f"flank scores reproduced", flush=True)

    reports = {}
    for B in (TIMED_B, 2048):
        args = pair_inputs(random_pairs(99, B, TIMED_L2), device, width=128)
        reports[B] = time_kernel(
            "kernel K2 (pair entry)", "band_align_tb",
            lambda args=args: align_cuda.band_align_traceback_pairs(*args),
            lambda args=args: align_torch.band_align_traceback_pairs_reference(
                *args),
            args[7], TIMED_L2 + 8, tb_bytes(args[:4], args[4:]))
    return dict(max_abs_err=max_err, **reports[TIMED_B])


# --- the fused window inference (csrc/infer_window.cu) ----------------------

INFER_NAMES = ("lik", "em", "freq", "gof", "ratios", "gl_rel", "em_margin")
# engine/caller._EM_MARGIN_EPS: a window whose EM margin is under it in
# either version may stop at another iteration (em, freq and ratios may
# then differ by up to tol), and the f64 guard sends it to the host.
EM_MARGIN_EPS = 1e-5
# Synthetic batches (W, Hb, Rb, I, Vb): two of the CTA route in shared
# memory, two past 227 KB (Hb = 256 with one individual, Hb = 64 with 30,
# whose 256 reads give each individual a few; the global route) and two of
# the warp route (a slice-like batch of Hb = 2, and Hb = 4 with 16
# individuals, as a cohort gives).  Phase 3 runs each on every route that
# fits it.
INFER_SHAPES = [(16, 12, 96, 1, 6), (8, 24, 192, 3, 4), (4, 256, 64, 1, 3),
                (6, 64, 256, 30, 4), (128, 2, 64, 1, 2), (64, 4, 128, 16, 4)]
# Transcendental (MUFU) results per SM per clock and float32 operations
# per SM per clock (128 FP32 lanes, an FMA counted as two) on Hopper.
MUFU_PER_SM_CLOCK = 16
F32_PER_SM_CLOCK = 256


def random_windows(seed, W, Hb, Rb, I, Vb):
    """A padded inference batch as parallel/batch.py builds one (numpy
    infer_window_batch inputs, h1/h2 int32 genotype_index_pairs(Hb)): W - 1
    windows of 2..Hb haps and 1..Rb reads with per-read log-likelihoods
    like the engine's, their reads over I individuals (with I > 2 the last
    one has none), 1..Vb variants on haps other than the reference; the
    last window is padding."""
    import numpy as np

    from platypus_tpu_torch.ops.likelihood import genotype_index_pairs

    rng = np.random.default_rng(seed)
    ll = np.zeros((W, Hb, Rb), np.float32)
    oh = np.zeros((W, I, Rb), np.float32)
    hm = np.zeros((W, Hb), bool)
    vm = np.zeros((W, Vb, Hb), bool)
    hr = np.zeros((W, I), bool)
    for k in range(W - 1):
        H, R = int(rng.integers(2, Hb + 1)), int(rng.integers(1, Rb + 1))
        ll[k, :H, :R] = np.maximum(-np.abs(rng.normal(3.0, 4.0, (H, R))),
                                   -300.0)
        sample = rng.integers(0, I, R)
        if I > 2:
            sample[sample == I - 1] = 0
        oh[k, sample, np.arange(R)] = 1.0
        hm[k, :H] = True
        for v in range(int(rng.integers(1, Vb + 1))):
            vm[k, v, 1:H] = rng.random(H - 1) < 0.5
        good = rng.random(R) < 0.9
        hr[k] = np.bincount(sample[good], minlength=I) > 0
    h1, h2 = genotype_index_pairs(Hb)
    return ll, oh, hm, h1.astype(np.int32), h2.astype(np.int32), vm, hr


def infer_tolerance(name):
    """(rtol, atol) of one output, those of tests/test_torch_likelihood.py:
    both versions run the same f32 algorithm in another summation order."""
    if name == "ratios":
        return 0.0, 1e-3
    if name == "em_margin":
        return 0.0, 1e-5
    return 1e-4, 1e-5


def compare_inference(got, want):
    """The seven outputs of two versions as numpy arrays -> (max |got -
    want| per output over the entries compared, guard-band windows, the
    outputs that differ).  Shapes, dtypes and the non-finite entries must
    agree element for element; em, freq and ratios skip the windows whose
    em_margin is under EM_MARGIN_EPS in either version."""
    import numpy as np

    margin_ok = np.minimum(got[6], want[6]) >= EM_MARGIN_EPS
    errs, bad = {}, []
    for name, g, w in zip(INFER_NAMES, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            bad.append(name)
            continue
        if name in ("em", "freq", "ratios"):
            g, w = g[margin_ok], w[margin_ok]
        fin = np.isfinite(w)
        pattern = (np.array_equal(np.isfinite(g), fin)
                   and np.array_equal(g[~fin], w[~fin], equal_nan=True))
        rtol, atol = infer_tolerance(name)
        errs[name] = (float(np.abs(g[fin].astype(np.float64) - w[fin]).max())
                      if fin.any() else 0.0)
        if not pattern or not np.allclose(g[fin], w[fin], rtol=rtol,
                                          atol=atol):
            bad.append(name)
    return errs, int((~margin_ok).sum()), bad


def infer_work(arrays, iters):
    """(bytes, transcendentals, f32 operations) the fused inference needs
    on one batch: numpy inputs `arrays` and the EM iterations each window
    ran.  Bytes: every input read once, the seven outputs written once.
    The rest counts each window's own haps (H), genotypes (Gw), reads (R),
    individuals with reads (n) and variants (V): the exact per-read branch
    (an exp and a log1p where 1e-3 < |l1 - l2| < 3), the Gw x R x I
    contraction (two FMAs), one exp per relative likelihood, per EM
    iteration 2 n Gw + H^2 + 3H exps and n + Gw + H logs, the outputs' exps,
    and the ratios' n Gw (V + 1) exps; f32 operations ~8 per table entry
    and iteration."""
    import numpy as np

    ll, oh, hm, h1, h2, vm, hr = arrays
    W, I = ll.shape[0], oh.shape[1]
    G = len(h1)
    n_bytes = sum(a.nbytes for a in arrays) + 4 * (
        4 * W * I * G + W * hm.shape[1] + W * vm.shape[1] + W)
    mufu = flops = 0
    for w in range(W):
        H, n, k = int(hm[w].sum()), int(hr[w].sum()), int(iters[w])
        if H == 0:
            continue
        reads = oh[w].any(axis=0)
        R, V = int(reads.sum()), int(vm[w].any(axis=1).sum())
        on = (h1 < H) & (h2 < H)
        Gw = int(on.sum())
        rows = ll[w][:H][:, reads]
        diff = np.abs(rows[h1[on]] - rows[h2[on]])
        exact = (h1[on] != h2[on])[:, None] & (diff > 1e-3) & (diff < 3.0)
        mufu += 2 * int(exact.sum()) + n * Gw
        flops += Gw * R * (4 * I + 6) + 4 * I * Gw
        mufu += k * (2 * n * Gw + n + Gw + H * H + 3 * H)
        flops += k * (8 * n * Gw + 4 * H * H + 4 * H)
        mufu += n * Gw + H + (n * Gw + n) + V * (H + 1 + n * (Gw + 1))
        flops += 5 * n * Gw * (1 + V)
    return n_bytes, mufu, flops


def infer_bound(works):
    """(bound_ms, bound_by) of the fused inference over batches of
    infer_work (bytes, transcendentals, f32 operations): the largest of
    the bytes over the memory rate, the transcendentals over the MUFU rate
    and the f32 operations over the FP32 rate of card 0 (SMs x per-clock
    rate x its maximum SM clock)."""
    import torch

    mhz = run_child(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"], check=True).stdout.strip()
    per_clock = torch.cuda.get_device_properties(0).multi_processor_count \
        * float(mhz) * 1e6
    n_bytes, mufu, flops = (sum(w[k] for w in works) for k in range(3))
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "transcendentals": mufu / (MUFU_PER_SM_CLOCK * per_clock) * 1e3,
             "f32 operations": flops / (F32_PER_SM_CLOCK * per_clock) * 1e3}
    print(f"bound: infer_window: {n_bytes} bytes ({times['bytes']:.6f} ms), "
          f"{mufu} transcendentals ({times['transcendentals']:.6f} ms), "
          f"{flops} f32 operations ({times['f32 operations']:.6f} ms)",
          flush=True)
    by = max(times, key=times.get)
    return times[by], by


GL_FLOOR = -690.77552  # gl_rel's floor, ln 1e-300 (likelihood_torch)
# On the entries where float32 cannot promise gl_rel's atol: how far the
# kernel may be from float64, as a multiple of the plain version's largest
# distance (both are float32 sums of the same terms in another order).
WIDE_GL_REL_FACTOR = 2.0


def gl_rel_float64(args):
    """gl_rel of a batch in float64 on the CPU (the plain version's
    per-read terms, sums over each individual's reads, the row's max and
    the floor) -> numpy (gl_rel [W, I, G]; the float32 summation bound of
    each entry, 2 n 2^-24 (|gl| + |row max|) with n the individual's
    reads: the most two orders of the two sums can differ by [W, I, G];
    the entries that are on: an enabled genotype in a row with reads)."""
    import torch

    from platypus_tpu_torch.ops import likelihood_torch

    ll, oh, hm, h1, h2, _vm, hr = (a.cpu() for a in args)
    pr, _ = likelihood_torch._per_read_genotype(ll.double(), h1.long(),
                                                h2.long())
    gl = torch.matmul(pr, oh.double().transpose(1, 2)).transpose(1, 2)
    gm = (hm[:, h1.long()] & hm[:, h2.long()])[:, None, :]
    top = torch.where(gm, gl, float("-inf")).amax(dim=2, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    rel = torch.clamp_min(gl - top, GL_FLOOR)
    n = (oh != 0).sum(dim=2, keepdim=True).double()
    bound = 2 * n * 2.0 ** -24 * (gl.abs() + top.abs())
    return rel.numpy(), bound.numpy(), (gm & hr[:, :, None]).numpy()


def check_wide_gl_rel(args, got, want):
    """gl_rel of the kernel (`got`) against the plain version (`want`),
    numpy, where compare_inference found it out of tolerance.  The
    non-finite entries must still agree element for element, and every
    entry is held to gl_rel's tolerance except the wide ones: on, finite
    and above the floor in both versions and in float64, where float32's
    summation bound (gl_rel_float64) exceeds atol, so that two orders of
    summation need not agree within it.  There each entry's distance from
    float64 must stay within atol plus WIDE_GL_REL_FACTOR times the plain
    version's largest distance over the wide entries, each distance
    measured in units of its entry's bound.  Returns (passed, a line that
    says what was compared)."""
    import numpy as np

    rtol, atol = infer_tolerance("gl_rel")
    rel, bound, on = gl_rel_float64(args)
    fin = np.isfinite(want)
    if not (np.array_equal(np.isfinite(got), fin)
            and np.array_equal(got[~fin], want[~fin], equal_nan=True)):
        return False, "gl_rel's non-finite entries differ"
    wide = (on & fin & (got > GL_FLOOR) & (want > GL_FLOOR) & (rel > GL_FLOOR)
            & (bound > atol))
    rest = fin & ~wide
    if not np.allclose(got[rest], want[rest], rtol=rtol, atol=atol):
        return False, ("gl_rel out of tolerance on entries where float32 "
                       "can meet it")
    if not wide.any():
        return True, "gl_rel: no entry where float32 cannot meet atol"
    dk, dp = (np.abs(v[wide] - rel[wide]) for v in (got, want))
    scale = WIDE_GL_REL_FACTOR * float((dp / bound[wide]).max())
    excess = float((dk - atol - scale * bound[wide]).max())
    return excess <= 0, (
        f"gl_rel on {int(wide.sum())} entries where float32's summation "
        f"bound exceeds atol {atol:g}: largest distance from float64 kernel "
        f"{float(dk.max()):.3e}, plain version {float(dp.max()):.3e}; in "
        f"units of each entry's bound, kernel "
        f"{float((dk / bound[wide]).max()):.4f}, plain "
        f"{float((dp / bound[wide]).max()):.4f} (limit atol + "
        f"{WIDE_GL_REL_FACTOR:g}x plain); every other entry within "
        f"tolerance, non-finite entries equal")


def check_infer_batch(what, args, em_iters=100, route=None):
    """The fused inference kernel against its plain version on one batch
    of device tensors `args` (infer_window_batch's inputs), on `route`
    (em_path's choice by default): every output within its tolerance
    (compare_inference), a second launch bitwise equal to the first.
    Returns (max abs error per output, guard-band windows, EM iterations
    per window as numpy, the kernel's route)."""
    import torch

    from platypus_tpu_torch.ops import likelihood_cuda, likelihood_torch

    _W, H, R = args[0].shape
    route = route or likelihood_cuda.em_path(H, args[1].shape[1], R)
    got, iters = likelihood_cuda.launch(*args, em_iters=em_iters, route=route)
    again, iters2 = likelihood_cuda.launch(*args, em_iters=em_iters,
                                           route=route)
    want = likelihood_torch.infer_window_batch(*args, em_iters=em_iters)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((*got, iters), (*again, iters2))):
        raise AssertionError(f"{what}: two launches of the fused inference "
                             "kernel gave different bits")
    errs, guard, bad = compare_inference([t.cpu().numpy() for t in got],
                                         [t.cpu().numpy() for t in want])
    if "gl_rel" in bad:
        # Where |gl| is large (tens of reads an individual), one f32 ulp of
        # it exceeds gl_rel's atol and no summation order meets it.
        passed, note = check_wide_gl_rel(args, got[5].cpu().numpy(),
                                         want[5].cpu().numpy())
        print(f"{what}: gl_rel differs from the plain version by "
              f"{errs['gl_rel']:.3e}, past its tolerance; {note}", flush=True)
        if passed:
            bad.remove("gl_rel")
    if bad:
        raise AssertionError(f"{what}: fused inference kernel ({route} "
                             f"route) != plain version in {bad}: {errs}")
    return errs, guard, iters.cpu().numpy(), route


def time_infer_batch(args, route=None, plain=True):
    """(kernel ms on the device alone, launches queued behind a sleep
    kernel; kernel ms back to back from the host; the plain version's ms
    back to back from the host; the plain version's ms on the device
    alone, one call queued behind the hold, or None where it waits for
    the device inside the call) on one batch, the kernel on `route`
    (em_path's choice by default).  With plain=False the plain version is
    not timed (None, None)."""
    from platypus_tpu_torch.ops import likelihood_cuda, likelihood_torch

    def kernel():
        return likelihood_cuda.launch(*args, route=route)

    def plain_call():
        return likelihood_torch.infer_window_batch(*args)

    plain_device = plain_host = None
    if plain:
        try:
            plain_device = cuda_ms(plain_call, 1, hold=True)
        except RuntimeError:
            plain_device = None
        plain_host = cuda_ms(plain_call, 3)
    return (cuda_ms(kernel, 20, hold=True), cuda_ms(kernel, 20), plain_host,
            plain_device)


def fmt_ms(ms):
    return "not measured (it waits for the device)" if ms is None \
        else f"{ms:.6f} ms"


def describe_batch(args):
    W, Hb, Rb = args[0].shape
    return f"W={W} Hb={Hb} Rb={Rb} I={args[1].shape[1]} Vb={args[5].shape[1]}"


def check_infer_kernel(device):
    """Phase 3 for the fused inference: the kernel against its plain
    version on INFER_SHAPES (every route that fits each: padded windows,
    haps, reads and variants, individuals without reads) and once with
    em_iters=3, two launches bitwise equal, then each timed on each route,
    em_path's choice marked."""
    import torch

    from platypus_tpu_torch.ops import likelihood_cuda

    for k, shape in enumerate(INFER_SHAPES):
        args = [torch.from_numpy(a).to(device)
                for a in random_windows(200 + k, *shape)]
        chosen = likelihood_cuda.em_path(shape[1], shape[3], shape[2])
        routes = [r for r in likelihood_cuda.ROUTES
                  if likelihood_cuda.route_fits(r, shape[1], shape[3])]
        for route in routes:
            for em_iters in ((100, 3) if k == 1 else (100,)):
                errs, guard, iters, _ = check_infer_batch(
                    f"infer_window, {describe_batch(args)}", args, em_iters,
                    route)
                print(f"kernel infer_window: {describe_batch(args)} em_iters="
                      f"{em_iters}, {route} route: within tolerance of the "
                      f"plain version, two launches bitwise equal; EM "
                      f"iterations max {int(iters.max())}, mean "
                      f"{float(iters.mean()):.2f}, {guard} guard-band "
                      f"windows; max abs error "
                      + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()),
                      flush=True)
            ms, host_ms, plain_ms, plain_device = time_infer_batch(
                args, route, plain=route == chosen)
            print(f"kernel infer_window: {describe_batch(args)}, {route} route"
                  f"{' (em_path)' if route == chosen else ''}: {ms:.6f} ms on "
                  f"the device, {host_ms:.6f} ms back to back from the host"
                  + (f"; plain torch {plain_ms:.6f} ms back to back, on the "
                     f"device {fmt_ms(plain_device)}" if route == chosen
                     else ""), flush=True)


class InferRecorder:
    """While entered: the inputs of every call of the fused inference's
    wrapper (likelihood_cuda.infer_window_batch, which
    parallel/batch.launch_fused_inference imports at each call), kept by
    reference, and the calls of its plain version through the wrapper's
    CPU route, which must stay 0 on the card."""

    def __init__(self):
        from platypus_tpu_torch.ops import likelihood_cuda

        self.batches, self.plain_calls = [], 0
        self._mod = likelihood_cuda
        self._wrapper = likelihood_cuda.infer_window_batch
        self._plain = likelihood_cuda.infer_window_batch_reference

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.batches.append((args, kwargs.get("em_iters", 100)))
            return self._wrapper(*args, **kwargs)

        def plain(*args, **kwargs):
            self.plain_calls += 1
            return self._plain(*args, **kwargs)

        self._mod.infer_window_batch = wrapper
        self._mod.infer_window_batch_reference = plain
        return self

    def __exit__(self, *exc):
        self._mod.infer_window_batch = self._wrapper
        self._mod.infer_window_batch_reference = self._plain


def iteration_ms(args, iters):
    """The warp route's measured latency of one EM iteration on a batch:
    its device time at em_iters = the slowest window's iterations, less
    its time at em_iters=1, over the iterations between (None where no
    window ran more than one)."""
    from platypus_tpu_torch.ops import likelihood_cuda

    top = int(iters.max())
    if top <= 1:
        return None
    full, one = (cuda_ms(lambda k=k: likelihood_cuda.launch(
        *args, em_iters=k, route="warp"), 20, hold=True) for k in (top, 1))
    return (full - one) / (top - 1)


def check_infer_batches(recorder, smi, label="slice", plain=True):
    """The fused inference kernel against its plain version on every batch
    a main-path run launched (InferRecorder), then each batch timed: the
    kernel on the device alone and back to back and, with `plain`, the
    plain version back to back (today's route before this kernel); with
    the bound over the EM iterations each window ran, and the chain
    floor: the slowest window's iterations of each batch times the warp
    route's measured latency of one iteration (iteration_ms, on the batch
    with the most).  Returns the report fields (times and bound summed over
    the batches) and the per-batch device times."""
    if recorder.plain_calls:
        raise AssertionError(f"{label}: the plain inference ran "
                             f"{recorder.plain_calls} times on the card")
    if not recorder.batches:
        raise AssertionError(f"{label}: no fused inference batch recorded")
    max_err, guard, works, totals = {}, 0, [], [0.0, 0.0, 0.0, 0.0]
    routes, iters_all, tops, per_batch = {}, [], [], []
    slowest = None
    for args, em_iters in recorder.batches:
        errs, g, iters, route = check_infer_batch(
            f"{label} batch {describe_batch(args)}", args, em_iters)
        for name, e in errs.items():
            max_err[name] = max(max_err.get(name, 0.0), e)
        guard += g
        routes[route] = routes.get(route, 0) + 1
        iters_all.extend(int(i) for i in iters)
        tops.append(int(iters.max()))
        if route == "warp" and (slowest is None or tops[-1] > slowest[2]):
            slowest = (args, iters, tops[-1])
        works.append(infer_work([a.cpu().numpy() for a in args], iters))
        times = time_infer_batch(args, plain=plain)
        per_batch.append(times[0])
        totals = [t + x if t is not None and x is not None else None
                  for t, x in zip(totals, times)]
        print(f"infer batch ({label}): {describe_batch(args)}, {route} route: "
              f"kernel {times[0]:.6f} ms on the device, {times[1]:.6f} ms back "
              f"to back; "
              + (f"plain {fmt_ms(times[2])} back to back, on the device "
                 f"{fmt_ms(times[3])}; " if plain else "plain not timed; ")
              + f"EM iterations max {int(iters.max())}, mean "
              f"{float(iters.mean()):.2f}; {g} guard-band windows", flush=True)
    bound_ms, bound_by = infer_bound(works)
    per_iter = iteration_ms(*slowest[:2]) if slowest else None
    chain = (f"{sum(tops) * per_iter:.6f} ms ({sum(tops)} iterations on the "
             f"batches' slowest windows x {per_iter * 1e3:.4f} us an "
             f"iteration of the warp route)" if per_iter else "not measured")
    print(f"infer batches on {smi}: {len(recorder.batches)} batches of the "
          f"{label}'s main path ({routes}), every output within tolerance of "
          f"the plain version, two launches bitwise equal; max abs error "
          + ", ".join(f"{n} {e:.3e}" for n, e in max_err.items())
          + f"; {guard} guard-band windows excluded from em/freq/ratios; EM "
          f"iterations per window: max {max(iters_all)}, mean "
          f"{sum(iters_all) / len(iters_all):.2f} over {len(iters_all)} "
          f"window rows; summed: kernel {totals[0]:.6f} ms on the device, "
          f"{totals[1]:.6f} ms back to back; "
          + (f"plain {fmt_ms(totals[2])} back to back, on the device "
             f"{fmt_ms(totals[3])}; " if plain else "plain not timed; ")
          + f"bound {bound_ms:.6f} "
          f"ms ({bound_by}), {bound_ms / totals[0]:.1%} of it; chain floor "
          f"{chain}", flush=True)
    return dict(max_abs_err=max(max_err.values()), ms=totals[0],
                plain_ms=totals[2], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), per_batch


def check_guard_with_plain(info, region, smi, kernel_to_host):
    """The slice once more with launch_fused_inference pointed at the plain
    version (a measurement here, never a switch of the package): its data
    lines equal the reference's, and how many device-inferred windows the
    f64 guard sends to the host with either route."""
    from platypus_tpu_torch.ops import likelihood_cuda, likelihood_torch

    out = os.path.join(info["workdir"], "port_plain_inference.vcf")
    wrapper = likelihood_cuda.infer_window_batch
    likelihood_cuda.infer_window_batch = likelihood_torch.infer_window_batch
    try:
        wall, counts = run_port(cli_args(info, region, out))
    finally:
        likelihood_cuda.infer_window_batch = wrapper
    n_lines = check_same_calls("plain inference", os.path.join(
        info["workdir"], "reference.vcf"), out)
    if counts["infer_window"] != 0:
        raise AssertionError(f"plain inference: the kernel ran: {counts}")
    print(f"guard: slice on {smi}: device_windows_to_host {kernel_to_host} "
          f"with the infer_window kernel, {counts['device_windows_to_host']} "
          f"with launch_fused_inference pointed at the plain version "
          f"({wall:.6f} s, {counts['batches']} batches); {n_lines} VCF data "
          f"lines byte-identical to the reference", flush=True)


def build_dataset(kind, workdir, *args):
    """A synthetic dataset built (or reused) in `workdir` by
    `python tests/test_torch_smoke_data.py kind workdir args...` in a child
    process -- its writers belong to the JAX package, which this script does
    not import.  Returns the dataset's description (a dict of paths)."""
    proc = run_child([sys.executable, DATASETS, kind, workdir,
                      *map(str, args)], cwd=REPO, timeout=600)
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
    """Zero the engine's spans and counters (GLOBAL_METRICS), the kernels'
    launch counts and the fused-inference count among them."""
    from platypus_tpu_torch.utils.observability import GLOBAL_METRICS

    GLOBAL_METRICS.reset()


def read_counts():
    """Launches per kernel library, fused-inference batches, pairs whose
    score the flank penalty lowered and device-inferred windows the f64
    guard sent to the host, since the last reset_counts()."""
    from platypus_tpu_torch.engine.region import metrics
    from platypus_tpu_torch.ops import align_cuda

    return dict(align_cuda.launches(), batches=metrics.counters["k3_batches"],
                flank_pairs_lowered=metrics.counters["flank_pairs_lowered"],
                device_windows_to_host=metrics.counters["device_windows_to_host"])


def run_port(argv):
    """The port's CLI on cuda, in this process; prints the engine's stage
    timers (host clock; device stages are queue + wait times) and returns
    (wall seconds, read_counts() of this run)."""
    import torch

    from platypus_tpu_torch import cli
    from platypus_tpu_torch.engine.region import metrics

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
    proc = run_child(cmd, cwd=cwd, env=env, timeout=900)
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
          f"{summary['regions']} regions ({summary['band_align']} K1 and "
          f"{summary['infer_window']} infer_window launches) "
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
    if (summary["regions"] < 1 or summary["band_align_tb"] < 1
            or summary["infer_window"] < 1):
        raise AssertionError(f"hybrid: the device worker called no region "
                             f"through K2 and the infer_window kernel: "
                             f"{summary}")
    ref_out = os.path.join(workdir, "reference_hybrid.vcf")
    ref_wall = run_reference(cli_args(info, HYBRID_REGION, ref_out,
                                      ("--calculateFlankScore=1", shard,
                                       "--nCPU=4")))
    n_lines = check_same_calls("hybrid", ref_out, out)
    print(f"hybrid: {HYBRID_REGION} --calculateFlankScore=1 {shard} on {smi}: "
          f"port CLI --nCPU=2 --tpuWorkers=1 {wall:.6f} s (claims host "
          f"{summary['host']} / device {summary['device']} / rescued "
          f"{summary['rescued']}; the device worker called "
          f"{summary['regions']} regions with {summary['band_align_tb']} K2, "
          f"{summary['band_align']} K1 and {summary['infer_window']} "
          f"infer_window launches); CPU-pinned reference CLI "
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
            or stats["windows"] <= 0 or stats["errors"] != 0
            or stats["infer_window_launches"] <= 0):
        raise AssertionError(f"service: served nothing on the card: {stats}")
    n_lines = check_same_calls("service", os.path.join(workdir, "reference.vcf"),
                               out)
    print(f"service: --nCPU=2 --inferenceService=1 on {smi}: port CLI "
          f"{wall:.6f} s, {stats['requests']} requests, {stats['windows']} "
          f"windows served, {stats['infer_window_launches']} infer_window "
          f"launches, {stats['errors']} errors; {n_lines} VCF data "
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
# kernel launch counts and then its engine spans and counters (counted
# from zero at its start) as its last two lines.
COUNTED_CLI = ("import json, sys\n"
               "from platypus_tpu_torch import cli\n"
               "from platypus_tpu_torch.ops import align_cuda\n"
               "from platypus_tpu_torch.utils.observability import GLOBAL_METRICS\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print('LAUNCHES ' + json.dumps(align_cuda.launches()), flush=True)\n"
               "print('METRICS ' + json.dumps(GLOBAL_METRICS.snapshot()), flush=True)\n"
               "sys.exit(rc)\n")


def counted_metrics(stdout):
    """GLOBAL_METRICS.snapshot() of a finished COUNTED_CLI process."""
    lines = [line for line in stdout.splitlines()
             if line.startswith("METRICS ")]
    return json.loads(lines[-1].split(" ", 1)[1])


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
    env = port_env()
    for name, reg, extra, ref_name, kernel in (
            ("mesh", region, (), "reference.vcf", "band_align"),
            ("mesh_flank", FLANK_REGION, ("--calculateFlankScore=1",),
             "reference_flank_region.vcf", "band_align_tb")):
        out = os.path.join(workdir, f"port_{name}.vcf")
        argv = cli_args(info, reg, out, ("--meshDevices=-1", *extra))
        t0 = time.perf_counter()
        proc = run_child([sys.executable, "-c", COUNTED_CLI, *argv],
                         cwd=REPO, env=env, timeout=900)
        wall = time.perf_counter() - t0
        launches, stdout = counted_result(proc, f"{out}.log")
        timers = {k: v for k, v in counted_metrics(stdout)["timers"].items()
                  if k.startswith("mesh_")}
        n_lines = check_same_calls(name, os.path.join(workdir, ref_name), out)
        if (launches[kernel] <= 0 or launches["infer_window"] <= 0
                or "mesh_pack_launch" not in timers):
            raise AssertionError(f"{name}: no {kernel} or infer_window launch "
                                 f"or no mesh spans: {launches}, {timers}")
        print(f"mesh: {reg} {' '.join(extra)} --meshDevices=-1 on {smi}: port "
              f"CLI {wall:.6f} s, {launches['band_align']} K1, "
              f"{launches['band_align_tb']} K2 and {launches['infer_window']} "
              f"infer_window launches, mesh spans summed over the run's "
              f"regions (s): {timers}; {n_lines} VCF data lines "
              f"byte-identical to the reference's default run", flush=True)


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
        if launched[kernel] <= 0 or launched["infer_window"] <= 0:
            raise AssertionError(f"mesh shards: no {kernel} or infer_window "
                                 f"launch: {launched}")
        print(f"mesh shards: {reg} {' '.join(extra)} on {smi}: "
              f"{[m.shape for m in meshes]} gave bitwise equal pair scores "
              f"({counts['pairs']} pairs, {counts['windows']} windows) and "
              f"identical calls ({counts['calls']}), also with the host path; "
              f"{launched[kernel]} {kernel} and {launched['infer_window']} "
              f"infer_window launches; {wall:.6f} s", flush=True)


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
            LAST_CHILD[:] = [[sys.executable, "-c", "COUNTED_CLI", *argv],
                             None]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", COUNTED_CLI, *argv], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = []
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=600)
            done = subprocess.CompletedProcess(proc.args, proc.returncode,
                                               stdout, stderr)
            LAST_CHILD[:] = [[*proc.args[:2], "COUNTED_CLI", *proc.args[3:]],
                             done]
            results.append(counted_result(done, f"{out}.{rank}.log")[0])
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


@contextlib.contextmanager
def scoped_env(name, value):
    """Environment variable `name` set to `value` in this process while
    entered; its previous state restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def trace_summary(path, symbols):
    """The numbers of a torch.profiler Chrome trace: its window (first
    event's start to last event's end), the device-busy time (the union of
    its GPU kernel, memcpy and memset intervals) and idle share, the CUDA
    kernel count, the host time in the kernel-launch API calls, the ten
    device ops with the most total time, and for each label of `symbols`
    the kernel events whose name holds one of its names."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, reach = 0.0, start
    for e in sorted(gpu, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            reach = hi
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    launch_api = [e for e in events if e.get("cat") == "cuda_runtime"
                  and e["name"].startswith(("cudaLaunchKernel",
                                            "cuLaunchKernel"))]
    by_op = {}
    for e in gpu:
        total, n = by_op.get(e["name"], (0.0, 0))
        by_op[e["name"]] = (total + e["dur"], n + 1)
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        window_ms=(end - start) / 1e3, busy_ms=busy / 1e3,
        idle_share=1 - busy / (end - start), kernels=len(kernels),
        launch_calls=len(launch_api),
        launch_api_ms=sum(e["dur"] for e in launch_api) / 1e3,
        top=[(name[:80], round(total / 1e3, 6), n)
             for name, (total, n) in top],
        matched={label: sum(any(s in e["name"] for s in names)
                            for e in kernels)
                 for label, names in symbols.items()})


def check_trace(info, smi):
    """Phase 17: the port on one 100 kb region of the slice in this
    process inside observability.trace("slice_region"), with
    PLATYPUS_TPU_TRACE_DIR set to a new directory; its data lines equal
    the CPU-pinned reference's on the same region, and the trace it wrote
    must hold GPU kernel events, K1's and the fused inference's among
    them."""
    import glob

    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.utils import observability

    workdir = info["workdir"]
    region = "chr20:1000-101000"
    trace_dir = tempfile.mkdtemp(prefix="trace_", dir=workdir)
    out = os.path.join(workdir, "port_trace.vcf")
    with scoped_env("PLATYPUS_TPU_TRACE_DIR", trace_dir):
        t0 = time.perf_counter()
        with observability.trace("slice_region"):
            wall, counts = run_port(cli_args(info, region, out))
        traced = time.perf_counter() - t0
    ref_out = os.path.join(workdir, "reference_trace.vcf")
    run_reference(cli_args(info, region, ref_out))
    n_lines = check_same_calls("trace", ref_out, out)
    files = glob.glob(os.path.join(trace_dir, "slice_region", "*.pt.trace.json"))
    if len(files) != 1 or counts["band_align"] <= 0:
        raise AssertionError(f"trace: {files} written, {counts['band_align']} "
                             f"K1 launches")
    # A K1 kernel function's name is its C entry's without the ptt_
    # prefix, with _kernel after it (csrc/band_align.cu); the fused
    # inference's two are named in csrc/infer_window.cu.
    symbols = {"K1": [entry[len("ptt_"):] + "_kernel"
                      for entry in align_cuda.KERNELS["band_align"].entries],
               "infer_window": ["infer_window_warp_kernel",
                                "infer_window_gl_kernel",
                                "infer_window_em_kernel"]}
    summary = trace_summary(files[0], symbols)
    if summary["kernels"] <= 0 or min(summary["matched"].values()) <= 0:
        raise AssertionError(f"trace: no GPU kernel event or none of K1 or "
                             f"of the fused inference ({symbols}): {summary}")
    print(f"trace: {region} on {smi} in this process, {wall:.6f} s "
          f"({traced:.6f} s with the profiler's start and trace write), "
          f"{counts['band_align']} K1 launches, {counts['batches']} "
          f"fused-inference batches ({counts['infer_window']} infer_window "
          f"launches), {n_lines} VCF data lines byte-identical "
          f"to the reference; trace {os.path.getsize(files[0])} bytes: window "
          f"{summary['window_ms']:.3f} ms, device busy {summary['busy_ms']:.3f}"
          f" ms, idle share {summary['idle_share']:.4f}, {summary['kernels']} "
          f"CUDA kernels ({summary['matched']['K1']} of K1, "
          f"{summary['matched']['infer_window']} of the fused inference), "
          f"{summary['launch_calls']}"
          f" kernel-launch API calls taking {summary['launch_api_ms']:.3f} ms "
          f"of host time; top device ops (name, ms, count): {summary['top']}",
          flush=True)


def check_cohort(smi):
    """Phase 18: the cohorts of COHORT_SAMPLES samples (one BAM each,
    built by tests/test_torch_smoke_data.py cohort in a child process)
    through the port on cuda in this process, recording every fused
    inference batch (InferRecorder), and through the CPU-pinned reference:
    data lines byte-identical; then once more with launch_fused_inference
    pointed at the plain version, byte-identical too, for
    device_windows_to_host with either route; then every recorded batch
    checked against the plain version and timed (check_infer_batches).
    Below 26 samples some device-inferred windows must reach the VCF; at
    30 the guard sends every one to the host, and the K3 time spent on
    them is printed.  Returns {samples: check_infer_batches' report}."""
    from platypus_tpu_torch.ops import likelihood_cuda, likelihood_torch

    reports = {}
    for n in COHORT_SAMPLES:
        t0 = time.perf_counter()
        workdir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                               f"cohort{n}x{COHORT_LENGTH}")
        info = build_dataset("cohort", workdir, n, COHORT_LENGTH,
                             COHORT_COVERAGE)
        built = time.perf_counter() - t0
        out = os.path.join(workdir, "port.vcf")
        with InferRecorder() as recorder:
            wall, counts = run_port(cli_args(info, info["region"], out))
        if counts["band_align"] <= 0 or counts["infer_window"] <= 0:
            raise AssertionError(f"cohort {n}: main path missed the card: "
                                 f"{counts}")
        ref_out = os.path.join(workdir, "reference.vcf")
        ref_wall = run_reference(cli_args(info, info["region"], ref_out))
        plain_out = os.path.join(workdir, "port_plain_inference.vcf")
        wrapper = likelihood_cuda.infer_window_batch
        likelihood_cuda.infer_window_batch = likelihood_torch.infer_window_batch
        try:
            plain_wall, plain_counts = run_port(cli_args(info, info["region"],
                                                         plain_out))
        finally:
            likelihood_cuda.infer_window_batch = wrapper
        n_lines = check_same_calls(f"cohort {n}", ref_out, out, plain_out)
        windows = sum(int(args[2].any(dim=1).sum())
                      for args, _ in recorder.batches)
        to_host = counts["device_windows_to_host"]
        if n <= 25 and to_host >= windows:
            raise AssertionError(f"cohort {n}: the guard sent all {windows} "
                                 f"device-inferred windows to the host")
        print(f"cohort: {n} samples, {info['n_reads']} reads over "
              f"{info['length']} bp ({built:.3f} s to build or load) on {smi}: "
              f"port on cuda in this process {wall:.6f} s ({counts['band_align']}"
              f" K1 launches, {counts['batches']} fused-inference batches, "
              f"{counts['infer_window']} infer_window launches, {windows} "
              f"device-inferred windows); CPU-pinned reference {ref_wall:.6f} s;"
              f" launch_fused_inference pointed at the plain version "
              f"{plain_wall:.6f} s; {n_lines} VCF data lines byte-identical in "
              f"all three; device_windows_to_host {to_host} with the "
              f"infer_window kernel, {plain_counts['device_windows_to_host']} "
              f"with the plain version", flush=True)
        report, per_batch = check_infer_batches(recorder, smi,
                                                f"cohort of {n}", plain=False)
        del recorder
        if n > 25:
            print(f"cohort: {n} samples: the f64 guard (n_ind > 25) sent "
                  f"{to_host} of {windows} device-inferred windows to the host;"
                  f" K3 time spent on results it threw away: "
                  f"{sum(per_batch):.6f} ms on the device over "
                  f"{len(per_batch)} batches", flush=True)
        reports[n] = report
    return reports


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
    start_phase("0 (imports)")
    from platypus_tpu_torch import native
    from platypus_tpu_torch.engine import caller as port_caller
    from platypus_tpu_torch.ops import align_cuda

    errors = ErrorRecords()
    logging.getLogger("platypus_tpu").addHandler(errors)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    start_phase("1 (device)")
    smi = run_child(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)", flush=True)
    if args.walls_against:
        return compare_walls(args.walls_against, args.pairs, smi)

    # one nvcc per kernel source and the native host library, all started
    # together
    start_phase("2 (build)")
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
        if name != "infer_window":
            sass_loop(name)

    start_phase("3 (kernel)")
    report = {"band_align": check_kernel(device),
              "band_align_tb": check_tb_kernel(device)}
    check_infer_kernel(device)
    errors.check("kernel")

    start_phase("4 (slice)")
    t0 = time.perf_counter()
    workdir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                           f"mb{SLICE_MB:g}")
    info = build_dataset("slice", workdir, SLICE_MB)
    info["workdir"] = workdir
    print(f"slice: dataset {info['n_reads']} reads over {info['length']} bp "
          f"({time.perf_counter() - t0:.3f} s to build or load)", flush=True)
    region = f"chr20:1000-{info['length'] + 1000}"
    port_out = os.path.join(info["workdir"], "port.vcf")
    with ChunkRecorder() as recorder, InferRecorder() as infer_recorder:
        wall, counts = run_port(cli_args(info, region, port_out))
    errors.check("slice")
    launches = {"band_align": counts["band_align"],
                "infer_window": counts["infer_window"]}
    kernel_to_host = counts["device_windows_to_host"]
    if (counts["band_align"] <= 0 or counts["batches"] <= 0
            or counts["infer_window"] <= 0):
        raise AssertionError(f"main path missed the card: {counts}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the port's main path")
    print(f"slice: port on cuda in this process (first call) {wall:.6f} s, "
          f"{info['n_reads'] / wall:.1f} reads/s, {counts['band_align']} "
          f"kernel launches, {counts['batches']} fused-inference batches "
          f"({counts['infer_window']} infer_window launches), "
          f"{kernel_to_host} device-inferred windows sent to the host by "
          f"the f64 guard", flush=True)
    print(f"slice: K1 launch sizes (pairs) {recorder.sizes}", flush=True)
    if recorder.first is None:
        raise AssertionError("slice: no call of K1's pair entry recorded")
    check_main_chunk(recorder.first, smi)
    errors.check("main-path chunk")
    report["infer_window"], _ = check_infer_batches(infer_recorder, smi)
    del infer_recorder
    errors.check("infer batches")

    start_phase("5 (reference)")
    cli_out = os.path.join(info["workdir"], "port_cli.vcf")
    cli_wall = run_port_cli(cli_args(info, region, cli_out), cli_out)
    ref_out = os.path.join(info["workdir"], "reference.vcf")
    ref_wall = run_reference(cli_args(info, region, ref_out))
    n_lines = check_same_calls("slice", ref_out, port_out, cli_out)
    print(f"reference: fresh interpreters, port CLI on cuda {cli_wall:.6f} s "
          f"({info['n_reads'] / cli_wall:.1f} reads/s), CPU-pinned platypus_tpu "
          f"{ref_wall:.6f} s ({info['n_reads'] / ref_wall:.1f} reads/s); "
          f"{n_lines} VCF data lines byte-identical", flush=True)
    check_guard_with_plain(info, region, smi, kernel_to_host)
    errors.check("guard with the plain inference")

    beam = {"calls": 0, "launches": 0}
    inner = port_caller._beam_search_haplotypes

    def counting_beam(*args, **kwargs):
        before = align_cuda.launches()["band_align"]
        out = inner(*args, **kwargs)
        beam["calls"] += 1
        beam["launches"] += align_cuda.launches()["band_align"] - before
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

    # --calculateFlankScore=1: the whole slice through K2, then a small
    # region byte for byte against the reference's scalar flank path
    start_phase("6 (flank)")
    flank = ("--calculateFlankScore=1",)
    flank_out = os.path.join(info["workdir"], "port_flank.vcf")
    with ChunkRecorder("band_align_traceback_pairs") as flank_recorder:
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
    print(f"flank: K2 launch sizes (pairs) {flank_recorder.sizes}", flush=True)
    if flank_recorder.first is None:
        raise AssertionError("flank: no call of K2's pair entry recorded")
    check_flank_chunk(flank_recorder.first, smi)
    errors.check("flank chunk")
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

    # --HLATyping=1 on a synthetic typing panel, scored through K1
    start_phase("7 (HLA)")
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

    # the multi-process run and continueCalling, each in fresh
    # interpreters (this process holds a CUDA context)
    for label, check, check_args in (
            ("8 (pool)", check_pool, (info, region, smi)),
            ("9 (hybrid)", check_hybrid, (info, smi)),
            ("10 (service)", check_service, (info, region, smi)),
            ("11 (resume)", check_resume, (info, smi)),
            # the mesh and the multi-host run
            ("12 (mesh CLI)", check_mesh_cli, (info, region, smi)),
            ("13 (mesh shards)", check_mesh_shards,
             (info, region, smi, torch.device("cuda", 0))),
            ("14 (dry run)", check_dryrun, (smi, torch.device("cuda", 0))),
            ("15 (distributed)", check_distributed, (info, region, smi))):
        start_phase(label)
        check(*check_args)
        errors.check(label)

    # a profiler trace of one region, the cohorts
    start_phase("17 (trace)")
    check_trace(info, smi)
    errors.check("trace")
    start_phase("18 (cohort)")
    check_cohort(smi)
    errors.check("cohort")
    start_phase("19 (report)")
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
    try:
        sys.exit(main())
    except Exception as exc:
        failure_report(exc)
        raise
