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
    from platypus_tpu_torch.engine import score as port_score
    from platypus_tpu_torch.utils.backend import DeviceError

    def failing_kernel(*args, **kwargs):
        raise RuntimeError("band_align kernel launch failed: CUDA error 719")

    monkeypatch.setattr(port_score, "band_align_padded", failing_kernel)
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


@pytest.mark.parametrize("flag", ["--nCPU=2", "--meshDevices=-1",
                                  "--distributed=1", "--inferenceService=1"])
def test_unsupported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match=flag.split("=")[0]):
        port_cli.main(["callVariants", "--bamFiles=x.bam", "--refFile=x.fa",
                       f"--logFileName={tmp_path}/log.txt", flag,
                       "-o", str(tmp_path / "out.vcf")], device="cpu")


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["callVariants", "--bamFiles=x.bam", "--refFile=x.fa",
                       "-o", str(tmp_path / "out.vcf")])
