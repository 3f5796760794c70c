"""The torch port's region pipeline runner against the JAX package's, on the
CPU: PLATYPUS_TPU_INFER_THREAD (the begin and finish stages on one helper
thread) and call_variants_in_region.  Each package reads the same files
through its own code; VCF data lines must be byte-identical.

Twin of tests/test_runner.py:265 test_inference_thread_parity (same 9 kb
reference, seeds 71/72, three regions), plus a --calculateFlankScore=1
CLI run with the thread on test_torch_e2e.py's dataset."""

import io
import threading

import pytest
import torch

from platypus_tpu.cli import main as jax_cli
from platypus_tpu.config import PlatypusConfig as JaxConfig
from platypus_tpu.engine.runner import run_single_process as jax_run
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.config import PlatypusConfig as PortConfig
from platypus_tpu_torch.engine import runner as port_runner
from platypus_tpu_torch.ops import align_cuda
from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam
from test_torch_e2e import _args, _data_lines, datasets  # noqa: F401
from torch_twin_util import JAX_PKG, PORT_PKG, module

REGIONS = [("chr20", 1000, 3000), ("chr20", 3000, 5000), ("chr20", 5000, 8500)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def thread_dataset(tmp_path_factory):
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


def _finish_threads(monkeypatch):
    """Record the name of the thread each finish_region_call runs on."""
    names = []
    inner = port_runner.finish_region_call

    def recording(*args, **kwargs):
        names.append(threading.current_thread().name)
        return inner(*args, **kwargs)

    monkeypatch.setattr(port_runner, "finish_region_call", recording)
    return names


def test_inference_thread_parity_with_jax(tmp_path, thread_dataset, monkeypatch):
    """The port's run_single_process with PLATYPUS_TPU_INFER_THREAD at "0"
    and at "1" (fused inference on, so the thread's begin stage queues it)
    writes the lines of the JAX package's inline run; with "1" a finish
    runs on the ptpu-infer thread, with "0" none does."""
    bam, ref_path = thread_dataset
    jax_out = str(tmp_path / "jax.vcf")
    monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", "0")
    jax_run(JaxConfig(bam_files=[bam], ref_file=ref_path,
                      regions=["chr20:1001-8500"], buffer_size=2000),
            REGIONS, jax_out)
    want = _lines(jax_out)
    assert len(want) > 5
    names = _finish_threads(monkeypatch)
    for mode in ("0", "1"):
        monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", mode)
        out = str(tmp_path / f"port_{mode}.vcf")
        config = PortConfig(bam_files=[bam], ref_file=ref_path,
                            regions=["chr20:1001-8500"], buffer_size=2000,
                            device_inference=1)
        names.clear()
        n = port_runner.run_single_process(config, REGIONS, out, CPU)
        assert _lines(out) == want
        assert n == len(want) - 1
        on_thread = [name for name in names if name.startswith("ptpu-infer")]
        assert len(names) == len(REGIONS)
        assert bool(on_thread) == (mode == "1"), names
    assert not [t for t in threading.enumerate() if t.name.startswith("ptpu-infer")]


def test_inference_thread_regions_done_once_each(tmp_path, thread_dataset,
                                                 monkeypatch):
    """With the thread, on_region_done is called once per region, from
    either thread, never two at a time."""
    bam, ref_path = thread_dataset
    monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", "1")
    seen, busy = [], threading.Lock()

    def on_done(region):
        assert busy.acquire(blocking=False), "two callbacks at once"
        try:
            seen.append(region)
        finally:
            busy.release()

    config = PortConfig(bam_files=[bam], ref_file=ref_path, buffer_size=2000)
    port_runner.run_single_process(config, REGIONS, str(tmp_path / "out.vcf"),
                                   CPU, on_region_done=on_done)
    assert sorted(seen) == REGIONS


def test_flank_cli_with_inference_thread_matches_jax(datasets, monkeypatch):  # noqa: F811
    """--calculateFlankScore=1 through the port's CLI with the thread (K2's
    plain version, the host backtrace, the fused inference) in three
    regions equals the JAX CLI's scalar flank path."""
    _name, workdir, ref_path = datasets("spread")
    extra = ["--calculateFlankScore=1", "--bufferSize=5000"]
    jax_out = f"{workdir}/jax_flank_thread.vcf"
    monkeypatch.setenv("PLATYPUS_TPU_DEVICE_FLANK", "0")
    assert jax_cli(_args(workdir, ref_path, jax_out,
                         ["--deviceInference=0", *extra])) == 0
    want = _data_lines(jax_out)
    assert want
    monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", "1")
    calls = []
    inner = align_cuda.band_align_traceback_pairs
    monkeypatch.setattr(align_cuda, "band_align_traceback_pairs",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    out = f"{workdir}/port_flank_thread.vcf"
    assert port_cli.main(_args(workdir, ref_path, out,
                               ["--deviceInference=1", *extra]),
                         device="cpu") == 0
    assert calls
    assert _data_lines(out) == want


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
def test_call_variants_in_region_matches_jax(thread_dataset, device):
    """The port's call_variants_in_region on the CPU (plain torch versions,
    fused inference) and on the host path writes the JAX package's lines."""
    bam, ref_path = thread_dataset
    region = ("chr20", 1000, 8500)
    n_want, want = _call_region(JAX_PKG, bam, ref_path, region, None)
    n_got, got = _call_region(PORT_PKG, bam, ref_path, region, device)
    assert n_want > 3
    assert (n_got, got) == (n_want, want)
