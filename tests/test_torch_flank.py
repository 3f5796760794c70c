"""--calculateFlankScore=1 end to end: the torch port's CLI (device="cpu": the
plain traceback DP and the host backtrace) against the CPU-pinned
JAX-package CLI (its scalar flank path).  VCF data lines must be
byte-identical on the datasets of test_torch_e2e.py, at default settings and
with the beam search forced; a failing traceback kernel stops the run."""

from unittest import mock

import pytest

from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.engine import score as port_score
from platypus_tpu_torch.ops import align_cuda
from test_torch_e2e import _args, _data_lines, _reference_lines, datasets  # noqa: F401

FLANK = "--calculateFlankScore=1"


@pytest.mark.parametrize("kind", ["spread", "clustered"])
@pytest.mark.parametrize("extra", [[], ["--maxHaplotypes=4"]])
def test_port_flank_cli_matches_jax_package(datasets, kind, extra):  # noqa: F811
    _name, workdir, ref_path = datasets(kind)
    want = _reference_lines(workdir, ref_path, [FLANK, *extra])
    assert want
    out = f"{workdir}/port_flank.vcf"
    tb = mock.patch.object(align_cuda, "band_align_traceback_padded",
                           wraps=align_cuda.band_align_traceback_padded)
    # On a device the port never takes the host path's scalar flank scoring.
    no_scalar = mock.patch.object(port_score, "_scalar_flank_scores",
                                  side_effect=AssertionError)
    with tb as tb_calls, no_scalar:
        rc = port_cli.main(_args(workdir, ref_path, out,
                                 ["--deviceInference=1", FLANK, *extra]),
                           device="cpu")
    assert rc == 0
    assert tb_calls.call_count > 0
    assert _data_lines(out) == want


def test_flank_kernel_failure_stops_the_run(tmp_path, datasets,  # noqa: F811
                                            monkeypatch):
    """A failing K2 raises out of the CLI: no window or region is skipped
    and the scalar path is never taken."""
    def failing_kernel(*args, **kwargs):
        raise RuntimeError("band_align_tb kernel launch failed: CUDA error 719")

    monkeypatch.setattr(align_cuda, "band_align_traceback_padded", failing_kernel)
    monkeypatch.setattr(port_score, "_scalar_flank_scores",
                        mock.Mock(side_effect=AssertionError))
    _name, workdir, ref_path = datasets("spread")
    out = str(tmp_path / "port_fail.vcf")
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        port_cli.main(_args(workdir, ref_path, out,
                            ["--deviceInference=1", FLANK]), device="cpu")
    with open(f"{workdir}/log.txt") as fh:
        log = fh.read()
    assert "Processing region" in log
    assert "skipped" not in log and "Exception" not in log
