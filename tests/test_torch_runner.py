"""The torch port's region pipeline runner against the JAX package's, on the
CPU: run_single_process under both of its schedules (--assemble=0 and 1),
and call_variants_in_region.  Each package reads the same files through
its own code; VCF data lines must be byte-identical.

The data is that of tests/test_runner.py:265 test_inference_thread_parity
(same 9 kb reference, seeds 71/72, three regions)."""

import io
import threading

import pytest
import torch

from platypus_tpu.config import PlatypusConfig as JaxConfig
from platypus_tpu.engine.runner import run_single_process as jax_run
from platypus_tpu_torch.config import PlatypusConfig as PortConfig
from platypus_tpu_torch.engine import runner as port_runner
from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam
from torch_twin_util import JAX_PKG, PORT_PKG, module

REGIONS = [("chr20", 1000, 3000), ("chr20", 3000, 5000), ("chr20", 5000, 8500)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def runner_dataset(tmp_path_factory):
    """test_inference_thread_parity's data: 9 kb reference (seed 71), five
    SNPs on one haplotype, 30x reads (seed 72); returns (bam, ref path)."""
    workdir = tmp_path_factory.mktemp("torch_runner")
    ref_path, ref_seq = make_reference(workdir, length=9000, seed=71)
    variants = []
    for p in (1500, 2500, 4500, 6500, 7500):
        alt = b"C" if ref_seq[p] != ord("C") else b"T"
        variants.append((p, 1, alt))
    reads = simulate_reads(
        [SimHaplotype(ref_seq, []), SimHaplotype(ref_seq, variants)],
        1000, 8500, coverage=30, seed=72)
    return write_synth_bam(workdir, reads, ref_len=9000), ref_path


def _lines(path):
    """Every line but the ## header lines (the #CHROM line included)."""
    with open(path) as fh:
        return [line for line in fh if not line.startswith("##")]


def _threads_of(monkeypatch, name):
    """Record the thread each call of engine.runner's `name` runs on."""
    threads = []
    inner = getattr(port_runner, name)

    def recording(*args, **kwargs):
        threads.append(threading.current_thread())
        return inner(*args, **kwargs)

    monkeypatch.setattr(port_runner, name, recording)
    return threads


@pytest.mark.parametrize("assemble", [0, 1])
def test_pipeline_runs_on_the_calling_thread(tmp_path, runner_dataset,
                                             monkeypatch, assemble):
    """run_single_process (fused inference on) writes the lines of the JAX
    package's run, and every region's begin, finish and on_region_done run
    on the thread that called it: the prefetch helper is the only other."""
    bam, ref_path = runner_dataset
    jax_out = str(tmp_path / "jax.vcf")
    jax_run(JaxConfig(bam_files=[bam], ref_file=ref_path, assemble=assemble,
                      regions=["chr20:1001-8500"], buffer_size=2000),
            REGIONS, jax_out)
    want = _lines(jax_out)
    assert len(want) > 5
    stages = {name: _threads_of(monkeypatch, name)
              for name in ("begin_region_inference", "finish_region_call")}
    done = []
    out = str(tmp_path / "port.vcf")
    config = PortConfig(bam_files=[bam], ref_file=ref_path, assemble=assemble,
                        regions=["chr20:1001-8500"], buffer_size=2000,
                        device_inference=1)
    n = port_runner.run_single_process(
        config, REGIONS, out, CPU,
        on_region_done=lambda region: done.append(threading.current_thread()))
    assert _lines(out) == want
    assert n == len(want) - 1
    me = threading.current_thread()
    for threads in (*stages.values(), done):
        assert threads == [me] * len(REGIONS)


@pytest.mark.parametrize("assemble", [0, 1])
def test_regions_done_once_each(tmp_path, runner_dataset, assemble):
    """on_region_done is called once per region, in region order."""
    bam, ref_path = runner_dataset
    seen = []
    config = PortConfig(bam_files=[bam], ref_file=ref_path, buffer_size=2000,
                        assemble=assemble)
    port_runner.run_single_process(config, REGIONS, str(tmp_path / "out.vcf"),
                                   CPU, on_region_done=seen.append)
    assert seen == REGIONS


def _call_region(pkg, bam, ref_path, region, device):
    """call_variants_in_region of package `pkg` over `region`, writing
    through its own VCFWriter; returns (lines written, data lines)."""
    cfg = module(pkg, "config")
    config = cfg.PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                                device_inference=1 if pkg == PORT_PKG else -1)
    bam_files, samples_by_bam, samples = module(pkg, "engine.runner").open_bams(config)
    ref = module(pkg, "io.fasta").FastaFile(config.ref_file)
    rt = cfg.derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen
    buf = io.StringIO()
    writer = module(pkg, "vcfout.writer").VCFWriter(buf, samples)
    args = (*region, bam_files, samples_by_bam, ref, config, rt, writer)
    if pkg == PORT_PKG:
        args += (device,)
    try:
        n = module(pkg, "engine.region").call_variants_in_region(*args)
    finally:
        for b in bam_files:
            b.close()
        ref.close()
    return n, buf.getvalue().splitlines(True)


@pytest.mark.parametrize("device", [CPU, None], ids=["cpu", "host"])
def test_call_variants_in_region_matches_jax(runner_dataset, device):
    """The port's call_variants_in_region on the CPU (plain torch versions,
    fused inference) and on the host path writes the JAX package's lines."""
    bam, ref_path = runner_dataset
    region = ("chr20", 1000, 8500)
    n_want, want = _call_region(JAX_PKG, bam, ref_path, region, None)
    n_got, got = _call_region(PORT_PKG, bam, ref_path, region, device)
    assert n_want > 3
    assert (n_got, got) == (n_want, want)
