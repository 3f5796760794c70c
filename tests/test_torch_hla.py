"""HLA typing (--HLATyping=1) in the torch port against the JAX package, on
the CPU: the port's call_hla_variants_in_region on the tests/test_hla.py
panel and on a panel of more than 150 alleles (so the two-round ranking
runs), the CLI with --calculateFlankScore=1 (windows called through the
traceback DP), and a failing kernel inside an HLA window stopping the run.
Each package reads the panel through its own config, BAM and FASTA
readers; every comparison is of VCF bytes."""

import io
from unittest import mock

import pytest
import torch

from platypus_tpu.cli import main as jax_cli
from platypus_tpu.engine import hla as jax_hla
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.engine import hla as port_hla
from platypus_tpu_torch.ops import align_cuda
from platypus_tpu_torch.utils.backend import DeviceError
from test_hla import hla_setup  # noqa: F401
from test_torch_smoke_data import hla_dataset
from torch_twin_util import JAX_PKG, PORT_PKG, module

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ranked_panel(tmp_path_factory):
    """160 alleles of a 300 bp region, 10x: more than HLA_MAX_HAPLOTYPES."""
    info = hla_dataset(str(tmp_path_factory.mktemp("hla_ranked")),
                       n_alleles=160, region_len=300, coverage=10)
    chrom, span = info["region"].split(":")
    start, end = (int(x) for x in span.split("-"))
    return dict(bam_path=info["bam"], ref_path=info["ref"],
                vcf_path=info["panel"], region=(start - 1, end))


def _call_region(pkg, panel, **device):
    """call_hla_variants_in_region of package `pkg` on the panel, with that
    package's config, BAM and FASTA readers."""
    cfg = module(pkg, "config")
    config = cfg.PlatypusConfig(
        bam_files=[panel["bam_path"]], ref_file=panel["ref_path"],
        hla_typing=1, long_haps=1, source_file=[panel["vcf_path"]],
        assemble=0, get_variants_from_bams=0, min_reads=2,
    )
    rt = cfg.derive_runtime(config, n_individuals=1)
    rt.rlen = 100
    out = io.StringIO()
    call = module(pkg, "engine.hla").call_hla_variants_in_region
    with module(pkg, "io.bam").BamFile(panel["bam_path"]) as bam, \
            module(pkg, "io.fasta").FastaFile(panel["ref_path"]) as ref:
        start, end = panel["region"]
        assert call("6", start, end, [bam], {bam: ["SAMPLE1"]}, ref, config,
                    rt, out, **device) == 1
    return out.getvalue()


@pytest.mark.parametrize("panel_name", ["hla_setup", "ranked_panel"])
def test_hla_region_matches_jax_package(request, panel_name):
    panel = request.getfixturevalue(panel_name)
    want = _call_region(JAX_PKG, panel)
    rank = mock.patch.object(port_hla, "_rank_haplotypes_two_rounds",
                             wraps=port_hla._rank_haplotypes_two_rounds)
    no_jax_rank = mock.patch.object(jax_hla, "_rank_haplotypes_two_rounds",
                                    side_effect=AssertionError)
    with rank as rank_calls, no_jax_rank:
        got = _call_region(PORT_PKG, panel, device=CPU)
    assert got == want and got.count("\n") == 1
    assert rank_calls.call_count == (panel_name == "ranked_panel")


def _hla_cli_args(panel, out, log, extra):
    start, end = panel["region"]
    return ["callVariants", f"--bamFiles={panel['bam_path']}",
            f"--refFile={panel['ref_path']}", f"--regions=6:{start + 1}-{end}",
            "--HLATyping=1", f"--source={panel['vcf_path']}", "--longHaps=1",
            "--assemble=0", f"--logFileName={log}", *extra, "-o", out]


def _data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def test_hla_flank_cli_matches_jax_package(tmp_path, hla_setup):  # noqa: F811
    """--HLATyping=1 --calculateFlankScore=1 with candidates from the reads:
    each HLA window is called through the port's call_window, whose
    alignments take the flank path."""
    extra = ["--calculateFlankScore=1"]
    want_out = str(tmp_path / "jax.vcf")
    assert jax_cli(_hla_cli_args(hla_setup, want_out, tmp_path / "jax.log",
                                 extra)) == 0
    out = str(tmp_path / "port.vcf")
    tb = mock.patch.object(align_cuda, "band_align_traceback_pairs",
                           wraps=align_cuda.band_align_traceback_pairs)
    with tb as tb_calls:
        assert port_cli.main(_hla_cli_args(hla_setup, out, tmp_path / "port.log",
                                           extra), device="cpu") == 0
    assert tb_calls.call_count > 0
    assert _data_lines(out) == _data_lines(want_out) and _data_lines(out)
    assert "skipped" not in (tmp_path / "port.log").read_text()


@pytest.mark.parametrize("kernel,extra", [
    # K1's main-path wrapper is its pair entry; the case keeps its id
    pytest.param("band_align_pairs", [], id="band_align_padded-extra0"),
    # K2's wrapper is its pair entry; the case keeps its id
    pytest.param("band_align_traceback_pairs", ["--calculateFlankScore=1"],
                 id="band_align_traceback_padded-extra1"),
])
def test_hla_window_kernel_failure_stops_the_run(tmp_path, hla_setup,  # noqa: F811
                                                 monkeypatch, kernel, extra):
    """A failing K1 (or, with flank scores, K2) inside an HLA window raises
    DeviceError out of the CLI instead of skipping the window or region."""
    def failing_kernel(*args, **kwargs):
        raise RuntimeError("kernel launch failed: CUDA error 719")

    monkeypatch.setattr(align_cuda, kernel, failing_kernel)
    window = mock.patch.object(port_hla, "call_hla_window_long_vars",
                               wraps=port_hla.call_hla_window_long_vars)
    log = tmp_path / "port.log"
    with window as window_calls, pytest.raises(DeviceError, match="CUDA error 719"):
        port_cli.main(_hla_cli_args(hla_setup, str(tmp_path / "port.vcf"), log,
                                    extra), device="cpu")
    assert window_calls.call_count == 1
    text = log.read_text()
    assert "Processing region" in text
    assert "skipped" not in text
