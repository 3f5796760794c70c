"""The torch port's device-owner inference service
(platypus_tpu_torch/engine/device_service.py) on the CPU: its server on
device="cpu" against the JAX package's, each fed the payloads its own
package builds, and the pool's host workers served through the port's
client, byte-identical to the JAX package's single-process output.

Twin of tests/test_device_service.py:53.  Where the JAX server stands
down or its failures pass unseen, the port's run fails: a server that
cannot own its device or records an error makes the run raise.
Tolerance of the fused inference, port against JAX: rtol 1e-4 / atol
1e-5 (tests/test_torch_likelihood.py).
"""

import json

import numpy as np
import pytest
import torch

from platypus_tpu.engine import device_service as jax_service
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import device_service as port_service
from torch_pool_util import (cli_args, data_lines, importers, make_dataset,
                             reference_lines, run_port_cli)
from torch_twin_util import JAX_PKG, PORT_PKG, module, prepare

SERVICE = ["--bufferSize=8000", "--nCPU=2", "--tpuWorkers=0",
           "--inferenceService=1"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_service"))
    return workdir, make_dataset(workdir)


def _service_env(stats_path, **extra):
    # A long grace makes the host workers take every response, so the
    # results are byte-compared; WAIT_READY removes the start-up race.
    return dict(PLATYPUS_TPU_SERVICE_GRACE="30",
                PLATYPUS_TPU_SERVICE_WAIT_READY="60",
                PLATYPUS_TPU_SERVICE_STATS=str(stats_path), **extra)


def test_service_served_and_byte_identical(tmp_path, dataset):
    """Two host workers whose fused inference the port's server runs: the
    stats show windows served without error, the output equals the JAX
    package's, only the parent and the server imported torch, and no
    process imported the JAX package."""
    workdir, ref_path = dataset
    want = reference_lines(workdir, ref_path, ["--bufferSize=8000"])
    out = str(tmp_path / "svc.vcf")
    stats_path = tmp_path / "stats.json"
    proc, imports = run_port_cli(tmp_path, cli_args(workdir, ref_path, out, SERVICE),
                                 **_service_env(stats_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert want and data_lines(out) == want
    stats = json.loads(stats_path.read_text())
    assert stats["backend"] == "cpu"
    assert stats["requests"] > 0 and stats["windows"] > 0
    assert stats["errors"] == 0
    assert importers(imports, "torch") == {"MainProcess",
                                           "ptpu-device-service"}, imports
    assert not importers(imports, "jax"), imports
    assert not importers(imports, "platypus_tpu"), imports


def test_server_dispatch_error_fails_the_run(tmp_path, dataset):
    """A server that answers a request with an error (its fused launch
    raises): the host workers finish the windows on the host path, as the
    protocol says, but the run then fails."""
    workdir, ref_path = dataset
    out = str(tmp_path / "svc_fail.vcf")
    stats_path = tmp_path / "stats.json"
    proc, _ = run_port_cli(tmp_path, cli_args(workdir, ref_path, out, SERVICE),
                           **_service_env(stats_path, PTT_TEST_SERVICE_FAIL="1"))
    assert proc.returncode != 0
    assert "device service exited with 1" in proc.stderr, proc.stderr[-3000:]
    stats = json.loads(stats_path.read_text())
    assert stats["errors"] > 0 and stats["requests"] == 0


def test_service_without_its_device_fails_the_run(tmp_path, dataset):
    """A server that cannot own the run's device (cuda on a host without
    one) does not stand down in silence: the run fails."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    workdir, ref_path = dataset
    out = str(tmp_path / "svc_nodev.vcf")
    stats_path = tmp_path / "stats.json"
    proc, _ = run_port_cli(tmp_path, cli_args(workdir, ref_path, out, SERVICE),
                           device="cuda", **_service_env(stats_path))
    assert proc.returncode != 0
    assert "device service exited with 1" in proc.stderr, proc.stderr[-3000:]
    assert json.loads(stats_path.read_text())["errors"] == 1


def _region_payloads(pkg, workdir, ref_path, device=None):
    """The service payloads (InferenceBatch.arrays() plus em_iters) of one
    30 kb region, prepared and aligned by package `pkg` (the port on
    `device`) and bucketed by its own build_inference_batches."""
    prep = prepare(pkg, ("chr20", 999, 29000), device,
                   bam_files=[f"{workdir}/reads.bam"], ref_file=ref_path,
                   output="-")
    try:
        state = prep.state
        logliks = state.pending.finalize()
    finally:
        prep.close()
    by_idx = {w_idx: ll for (w_idx, _p), ll in zip(state.live, logliks)}
    payloads = []
    for b in module(pkg, "parallel.batch").build_inference_batches(
            state.live, by_idx, len(state.buffers)):
        payload = b.arrays()
        payload["em_iters"] = 100
        payloads.append(payload)
    return payloads


def test_server_dispatch_matches_jax(dataset):
    """_dispatch_infer/_finalize_infer on the CPU against the JAX
    package's (its launch_fused_inference on XLA:CPU), each on the
    payloads its own package's host worker ships for one region; the
    payloads themselves are equal."""
    payloads = _region_payloads(PORT_PKG, *dataset, torch.device("cpu"))
    jax_payloads = _region_payloads(JAX_PKG, *dataset)
    assert payloads and len(payloads) == len(jax_payloads)
    for payload, jax_payload in zip(payloads, jax_payloads):
        assert payload.keys() == jax_payload.keys()
        for key, value in payload.items():
            assert np.array_equal(value, jax_payload[key]), key
        got = port_service._finalize_infer(
            port_service._dispatch_infer(payload, torch.device("cpu")))
        want = jax_service._finalize_infer(
            jax_service._dispatch_infer(jax_payload))
        for name, g, w in zip(("em", "freq", "ratios", "margin"), got, want):
            assert g.dtype == np.float64 and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_should_start_service_keyed_on_the_device(monkeypatch):
    """device_service.py:236-256's policy, with "pinned to a non-TPU
    backend" read as "the run's device is not CUDA"."""
    monkeypatch.delenv("PLATYPUS_TPU_INFERENCE_SERVICE", raising=False)
    start = port_service.should_start_service
    cfg = PlatypusConfig(bam_files=["x"], ref_file="y", output="z")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not start(cfg, 4, cuda)          # default --inferenceService=0
    cfg.inference_service = 1
    assert start(cfg, 4, cpu)
    cfg.inference_service = -1
    assert start(cfg, 4, cuda)
    assert not start(cfg, 4, cpu)
    assert not start(cfg, 1, cuda)
    monkeypatch.setenv("PLATYPUS_TPU_INFERENCE_SERVICE", "0")
    assert not start(cfg, 4, cuda)
