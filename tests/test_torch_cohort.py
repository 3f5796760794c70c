"""Multi-sample calling through the torch port (device="cpu", fused
inference on, I > 1) against the CPU-pinned JAX-package CLI (native
kernels, float64 host inference) on tools/cohort_bench.py's synthetic
cohort: one BAM per sample, common SNPs at drawn frequencies, one private
SNP per sample.  VCF data lines must be byte-identical:

- 3 samples at the defaults, where the device inference feeds the VCF
  for most windows (the f64 guard sends the rest to the host);
- the same 3 samples with --useEMLikelihoods=1, where the guard sends
  every device-inferred window to the host;
- 26 samples, past engine/caller.py's n_ind > 25 guard, which also sends
  every window to the host.
"""

import os
from unittest import mock

import pytest

from platypus_tpu.cli import main as jax_cli
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.engine import caller as port_caller
from test_torch_smoke_data import cohort_dataset

# (samples, length bp, coverage per sample)
COHORTS = {3: (3, 6000, 6), 26: (26, 4000, 3)}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    built = {}

    def get(n_samples):
        if n_samples not in built:
            workdir = str(tmp_path_factory.mktemp(f"torch_cohort_{n_samples}"))
            built[n_samples] = cohort_dataset(workdir, *COHORTS[n_samples])
        return built[n_samples]

    return get


def _args(info, out, extra):
    return ["callVariants", f"--bamFiles={info['bam']}",
            f"--refFile={info['ref']}", f"--regions={info['region']}",
            f"--logFileName={out}.log", *extra, "-o", out]


def _data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


@pytest.mark.parametrize("n_samples,extra,device_feeds", [
    (3, [], True),
    (3, ["--useEMLikelihoods=1"], False),
    (26, [], False),
], ids=["3-samples", "3-samples-em-likelihoods", "26-samples"])
def test_port_cohort_matches_jax_package(cohorts, tmp_path, n_samples, extra,
                                         device_feeds):
    info = cohorts(n_samples)
    want_out = str(tmp_path / "jax.vcf")
    assert jax_cli(_args(info, want_out, ["--deviceInference=0", *extra])) == 0
    want = _data_lines(want_out)
    assert len(want) > n_samples
    assert all(len(line.split("\t")) == 9 + n_samples for line in want)

    decisions = []
    guard = port_caller._device_window_needs_host

    def counted_guard(*args, **kwargs):
        decisions.append(guard(*args, **kwargs))
        return decisions[-1]

    out = str(tmp_path / "port.vcf")
    with mock.patch.object(port_caller, "_device_window_needs_host",
                           counted_guard):
        rc = port_cli.main(_args(info, out, ["--deviceInference=1", *extra]),
                           device="cpu")
    assert rc == 0
    assert _data_lines(out) == want
    # Every window went through the fused inference; the guard let the
    # device's results through for some only where it may.
    assert decisions
    assert (decisions.count(False) > 0) == device_feeds
    assert os.path.exists(f"{out}.log")
