"""End to end: the torch port's CLI (device="cpu", fused inference on) against
the CPU-pinned JAX-package CLI (native kernels, float64 host inference).
VCF data lines must be byte-identical, at default settings and with the
beam search forced (--maxHaplotypes=4 on clustered variants)."""

import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from platypus_tpu.cli import main as jax_cli
from platypus_tpu.engine import caller as jax_caller
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.engine import caller as port_caller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION = "--regions=chr20:1000-15000"


def _snp(ref_seq, pos):
    return (pos, 1, b"A" if ref_seq[pos] != ord("A") else b"C")


def _build_dataset(kind, workdir):
    """'spread' is test_device_inference.py:118's dataset; 'clustered'
    packs SNPs at 3000/3012, a TTA insertion at 3030, a SNP at 6100 and a
    2 bp deletion at 6115, so --maxHaplotypes=4 sends windows to the beam
    search."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    ref_path, ref_seq = make_reference(workdir, length=24000, seed=11)
    if kind == "spread":
        variants = [_snp(ref_seq, 3000), (6100, 3, b""), (9050, 0, b"TTA"),
                    (12500, 1, b"G" if ref_seq[12500] != ord("G") else b"T")]
    else:
        variants = [_snp(ref_seq, 3000), _snp(ref_seq, 3012), (3030, 0, b"TTA"),
                    _snp(ref_seq, 6100), (6115, 2, b"")]
    reads = simulate_reads([SimHaplotype(ref_seq, variants),
                            SimHaplotype(ref_seq, [])], 1000, 15000,
                           coverage=30, error_rate=0.002, seed=5,
                           fast_errors=True)
    write_synth_bam(workdir, reads, ref_len=24000)
    return kind, workdir, ref_path


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """kind -> (kind, workdir, ref path), each built once per module."""
    built = {}

    def get(kind):
        if kind not in built:
            workdir = str(tmp_path_factory.mktemp(f"torch_e2e_{kind}"))
            built[kind] = _build_dataset(kind, workdir)
        return built[kind]

    return get


def _args(workdir, ref_path, out, extra):
    return ["callVariants", f"--bamFiles={workdir}/reads.bam",
            f"--refFile={ref_path}", REGION, f"--logFileName={workdir}/log.txt",
            *extra, "-o", out]


def _data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def _reference_lines(workdir, ref_path, extra):
    out = f"{workdir}/jax_{'_'.join(extra) or 'default'}.vcf"
    if not os.path.exists(out):
        assert jax_cli(_args(workdir, ref_path, out,
                             ["--deviceInference=0", *extra])) == 0
    return _data_lines(out)


@pytest.mark.parametrize("kind", ["spread", "clustered"])
@pytest.mark.parametrize("extra", [[], ["--maxHaplotypes=4"]])
def test_port_cli_matches_jax_package(datasets, kind, extra):
    name, workdir, ref_path = datasets(kind)
    want = _reference_lines(workdir, ref_path, extra)
    assert want
    out = f"{workdir}/port.vcf"
    beam = mock.patch.object(port_caller, "_beam_search_haplotypes",
                             wraps=port_caller._beam_search_haplotypes)
    # The port must never reach the JAX package's scorer.
    no_jax_beam = mock.patch.object(jax_caller, "_beam_search_haplotypes",
                                    side_effect=AssertionError)
    with beam as beam_calls, no_jax_beam:
        rc = port_cli.main(_args(workdir, ref_path, out,
                                 ["--deviceInference=1", *extra]),
                           device="cpu")
    assert rc == 0
    assert _data_lines(out) == want
    if name == "clustered" and extra:
        assert beam_calls.call_count > 0


def test_beam_search_device_failure_stops_the_run(tmp_path, datasets,
                                                  monkeypatch):
    """A kernel failure inside a beam-search window is not contained by the
    window containment: the CLI raises, and no window is skipped."""
    from platypus_tpu_torch.ops import align_cuda
    from platypus_tpu_torch.utils.backend import DeviceError

    def failing_kernel(*args, **kwargs):
        raise RuntimeError("band_align kernel launch failed: CUDA error 719")

    monkeypatch.setattr(align_cuda, "band_align_padded", failing_kernel)
    _name, workdir, ref_path = datasets("clustered")
    out = str(tmp_path / "port_fail.vcf")
    with pytest.raises(DeviceError, match="CUDA error 719"):
        port_cli.main(_args(workdir, ref_path, out,
                            ["--deviceInference=1", "--maxHaplotypes=4"]),
                      device="cpu")
    with open(f"{workdir}/log.txt") as fh:
        log = fh.read()
    assert "Processing region" in log
    assert "Exception preparing window" not in log


def test_port_cli_runs_with_jax_blocked(tmp_path, datasets):
    """A fresh interpreter where `import jax` fails: the port runs the
    clustered beam-search case and never loads jax."""
    _name, workdir, ref_path = datasets("clustered")
    extra = ["--maxHaplotypes=4"]
    want = _reference_lines(workdir, ref_path, extra)
    out = str(tmp_path / "port_nojax.vcf")
    code = f"""
import importlib.abc, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, BlockJax())
from platypus_tpu_torch.cli import main
assert main({_args(workdir, ref_path, out, ["--deviceInference=1", *extra])!r},
            device="cpu") == 0
assert "jax" not in sys.modules
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PLATYPUS_TPU_PLATFORM", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _data_lines(out) == want


SOMATIC_VCF = (
    "##fileformat=VCFv4.0\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tNORMAL\tTUMOUR\n"
    "chr1\t100\t.\tA\tG\t200\tPASS\tTC=50\tGT:GL:GQ:NR:NV\t"
    "0/0:0.0,-30.0,-60.0:99:25:0\t0/1:-30.0,0.0,-25.0:99:25:12\n"
    "chr1\t200\t.\tC\tT\t200\tPASS\tTC=50\tGT:GL:GQ:NR:NV\t"
    "0/1:-30.0,0.0,-25.0:99:25:12\t0/1:-30.0,0.0,-25.0:99:25:13\n")
TRIO_VCF = (
    "##fileformat=VCFv4.0\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tCHILD\tDAD\tMUM\n"
    "chr1\t100\t.\tA\tG\t500\tPASS\tTC=50\tGT:GL:GQ:NR:NV\t"
    "0/1:-30.0,0.0,-25.0:99:25:12\t0/0:0.0,-30.0,-60.0:99:25:0\t"
    "0/0:0.0,-30.0,-60.0:99:25:0\n"
    "chr1\t200\t.\tC\tT\t500\tPASS\tTC=50\tGT:GL:GQ:NR:NV\t"
    "0/1:-30.0,0.0,-25.0:99:25:12\t0/1:-30.0,0.0,-25.0:99:25:11\t"
    "0/0:0.0,-30.0,-60.0:99:25:0\n")
TRIO_PED = ("FAM1\tCHILD\tDAD\tMUM\t2\t2\nFAM1\tDAD\t0\t0\t1\t1\n"
            "FAM1\tMUM\t0\t0\t2\t1\n")


def test_somatic_matches_jax_cli(tmp_path):
    """`somatic` through the port's CLI writes the JAX CLI's file, byte
    for byte (tests/test_heads.py's tumour/normal records)."""
    src = tmp_path / "tn.vcf"
    src.write_text(SOMATIC_VCF)
    outs = {}
    for who, main in (("port", port_cli.main), ("jax", jax_cli)):
        out = tmp_path / f"somatic_{who}.vcf"
        assert main(["somatic", f"--inputVCF={src}", f"--outputVCF={out}",
                     "--tumourSample=TUMOUR", "--normalSample=NORMAL"]) == 0
        outs[who] = out.read_text()
    assert outs["port"] == outs["jax"]
    assert "chr1\t100" in outs["port"] and "chr1\t200" not in outs["port"]


def test_denovo_matches_jax_cli(tmp_path):
    """`denovo inVCF pedFile` through the port's CLI writes the JAX CLI's
    three files, byte for byte (tests/test_heads.py's trio records)."""
    suffixes = ("mendelErrors", "deNovoVariants",
                "deNovoVariantsPassingBayesianFilter")
    outs = {}
    for who, main in (("port", port_cli.main), ("jax", jax_cli)):
        work = tmp_path / who
        work.mkdir()
        (work / "trio.vcf").write_text(TRIO_VCF)
        (work / "trio.ped").write_text(TRIO_PED)
        assert main(["denovo", str(work / "trio.vcf"),
                     str(work / "trio.ped")]) == 0
        outs[who] = [(work / f"trio_{sfx}.vcf").read_text()
                     for sfx in suffixes]
    assert outs["port"] == outs["jax"]
    assert "chr1\t100" in outs["port"][2]


def test_usage_names_every_command(capsys):
    assert port_cli.main(["--help"]) == 0
    usage = capsys.readouterr().out
    for command in ("callVariants", "continueCalling", "somatic", "denovo"):
        assert command in usage
    assert port_cli.main(["bogus"]) == 2


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["callVariants", "--bamFiles=x.bam", "--refFile=x.fa",
                       "-o", str(tmp_path / "out.vcf")])
