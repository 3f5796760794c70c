#!/usr/bin/env python3
"""On-card smoke test of the torch port (platypus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
without either it exits non-zero before printing any result.  Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: the banded-alignment kernel (csrc/band_align.cu, nvcc for
   sm_90a);
3. kernel: the CUDA kernel bitwise against its plain torch version on the
   card -- every reference golden, and main-path shapes (B = 16384, 2048
   and 2000 pairs at read lengths 100 and 128, mixed lengths, 'N' bases)
   -- then both timed with CUDA events at B=16384, L2=100;
4. slice: `platypus_tpu_torch.cli.main(["callVariants", ...])` on cuda
   over a synthetic 1 Mb, 30x, 100 bp dataset (ten 100 kb regions), with
   counters showing the kernel and the fused inference ran (this first
   call also builds the native host library on a fresh checkout); then
   one more 100 kb region with --maxHaplotypes=4 so the beam search aligns
   through the kernel too;
5. reference: the JAX package's CLI pinned to the CPU (native kernels,
   float64 inference, no jax import) on the same data; the port's VCF
   data lines must be byte-identical to it in both runs.  For a like for
   like time, the port's CLI also runs in a fresh interpreter, as the
   reference does: both walls include interpreter start and imports.

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

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens", "align_goldens.json")
KERNEL_SOURCE = "platypus_tpu_torch/csrc/band_align.cu"
KERNEL_REPLACES = "platypus_tpu/ops/align_pallas.py:48"
SLICE_MB = 1.0
TIMED_B, TIMED_L2 = 16384, 100


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
    for seed, (B, L2) in enumerate([(16384, 100), (16384, 128), (2048, 100),
                                    (2048, 128), (2000, 100), (2000, 128)]):
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


def slice_dataset():
    """The synthetic 1 Mb, 30x, 100 bp dataset of tools/scaling_bench.py,
    cached under the temporary directory."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from scaling_bench import build_dataset

    length = int(SLICE_MB * 1_000_000)
    workdir = os.path.join(tempfile.gettempdir(), "platypus_tpu_torch_smoke",
                           f"mb{SLICE_MB:g}")
    info = build_dataset(workdir, length)
    info["workdir"] = workdir
    return info


def data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def cli_args(info, region, out, extra=()):
    return ["callVariants", f"--bamFiles={info['bam']}",
            f"--refFile={info['ref']}", f"--regions={region}",
            f"--logFileName={out}.log", "--verbosity=1", *extra, "-o", out]


def run_port(info, region, out, extra=()):
    """The port's CLI on cuda, in this process; prints the engine's stage
    timers (host clock; device stages are queue + wait times) and returns
    (wall seconds, kernel launches, fused-inference batches) of this run."""
    import torch

    from platypus_tpu_torch import cli
    from platypus_tpu_torch.engine.region import metrics
    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.parallel import batch

    metrics.reset()
    align_cuda.LAUNCHES = 0
    batch.BATCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(cli_args(info, region, out, extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"port CLI returned {rc}")
    print(f"stages: {metrics.summary()}", flush=True)
    return wall, align_cuda.LAUNCHES, batch.BATCHES


def run_cli(package, info, region, out, extra=(), env=None):
    """`python -m <package>.cli callVariants ...` in a fresh interpreter;
    returns its wall seconds (interpreter start and imports included)."""
    cmd = [sys.executable, "-m", f"{package}.cli",
           *cli_args(info, region, out, extra)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{package} CLI failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return wall


def run_port_cli(info, region, out, extra=()):
    """The port's CLI on cuda in a fresh interpreter; fails on any ERROR
    line of its log.  Returns its wall seconds."""
    wall = run_cli("platypus_tpu_torch", info, region, out, extra)
    with open(f"{out}.log") as fh:
        errors = [line for line in fh if " - ERROR - " in line
                  or " - CRITICAL - " in line]
    if errors:
        raise RuntimeError("port CLI logged ERROR records:\n" + "".join(errors))
    return wall


def run_reference(info, region, out, extra=()):
    """The JAX package's CLI pinned to the CPU, in a fresh interpreter;
    returns its wall seconds."""
    env = dict(os.environ, PLATYPUS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    return run_cli("platypus_tpu", info, region, out,
                   ("--deviceInference=0", *extra), env=env)


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

    # 2. build
    t0 = time.perf_counter()
    align_cuda.load()
    print(f"build: band_align kernel in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in align_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas: {line.strip()}", flush=True)

    # 3. kernel
    report = check_kernel(device)
    errors.check("kernel")

    # 4. slice on cuda, 5. the CPU-pinned reference on the same data
    t0 = time.perf_counter()
    info = slice_dataset()
    print(f"slice: dataset {info['n_reads']} reads over {info['length']} bp "
          f"({time.perf_counter() - t0:.3f} s to build or load)", flush=True)
    region = f"chr20:1000-{info['length'] + 1000}"
    port_out = os.path.join(info["workdir"], "port.vcf")
    wall, launches, batches = run_port(info, region, port_out)
    errors.check("slice")
    if launches <= 0 or batches <= 0:
        raise AssertionError(f"main path missed the card: {launches} kernel "
                             f"launches, {batches} fused-inference batches")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the port's main path")
    print(f"slice: port on cuda in this process (first call) {wall:.6f} s, "
          f"{info['n_reads'] / wall:.1f} reads/s, {launches} kernel launches, "
          f"{batches} fused-inference batches", flush=True)

    cli_out = os.path.join(info["workdir"], "port_cli.vcf")
    cli_wall = run_port_cli(info, region, cli_out)
    ref_out = os.path.join(info["workdir"], "reference.vcf")
    ref_wall = run_reference(info, region, ref_out)
    n_lines = check_same_calls("slice", ref_out, port_out, cli_out)
    print(f"reference: fresh interpreters, port CLI on cuda {cli_wall:.6f} s "
          f"({info['n_reads'] / cli_wall:.1f} reads/s), CPU-pinned platypus_tpu "
          f"{ref_wall:.6f} s ({info['n_reads'] / ref_wall:.1f} reads/s); "
          f"{n_lines} VCF data lines byte-identical", flush=True)

    beam = {"calls": 0, "launches": 0}
    inner = port_caller._beam_search_haplotypes

    def counting_beam(*args, **kwargs):
        before = align_cuda.LAUNCHES
        out = inner(*args, **kwargs)
        beam["calls"] += 1
        beam["launches"] += align_cuda.LAUNCHES - before
        return out

    port_caller._beam_search_haplotypes = counting_beam
    beam_region = "chr20:1000-101000"
    extra = ("--maxHaplotypes=4",)
    port_beam = os.path.join(info["workdir"], "port_beam.vcf")
    try:
        beam_wall, _, _ = run_port(info, beam_region, port_beam, extra)
    finally:
        port_caller._beam_search_haplotypes = inner
    errors.check("beam search")
    if beam["calls"] <= 0 or beam["launches"] <= 0:
        raise AssertionError(f"beam search did not run through the kernel: {beam}")
    cli_beam = os.path.join(info["workdir"], "port_cli_beam.vcf")
    cli_beam_wall = run_port_cli(info, beam_region, cli_beam, extra)
    ref_beam = os.path.join(info["workdir"], "reference_beam.vcf")
    ref_beam_wall = run_reference(info, beam_region, ref_beam, extra)
    n_lines = check_same_calls("--maxHaplotypes=4", ref_beam, port_beam, cli_beam)
    print(f"beam: {beam['calls']} beam searches, {beam['launches']} kernel "
          f"launches; port in this process {beam_wall:.6f} s; fresh "
          f"interpreters: port CLI {cli_beam_wall:.6f} s, reference "
          f"{ref_beam_wall:.6f} s; {n_lines} VCF data lines byte-identical",
          flush=True)
    errors.check("reference")

    print(json.dumps({"kernels": [dict(
        name="band_align", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, **report)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
