"""The torch port's multi-process run and its region containment, on the
CPU: the port's CLI on device="cpu" (plain torch versions) against the
CPU-pinned JAX package.

Twins of tests/test_device_service.py's hybrid-pool tests (:142, :295,
:320) and of tests/test_runner.py:100 (continueCalling).  VCF data lines
must be byte-identical to the JAX package's single-process output.
Where the JAX package survives a device worker's death, the port fails
the run.  The pool's processes run in a fresh interpreter whose
sitecustomize (torch_pool_util.SITECUSTOMIZE) logs torch and JAX-package
imports, blocks jax and can slow the host workers down.
"""

import os
from unittest import mock

import pytest
import torch

from platypus_tpu.cli import main as jax_cli
from platypus_tpu.engine import region as jax_region
from platypus_tpu.engine import score as jax_score
from platypus_tpu.engine.runner import continue_calling as jax_continue
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import region as port_region
from platypus_tpu_torch.engine import runner as port_runner
from platypus_tpu_torch.engine import score as port_score
from platypus_tpu_torch.parallel import batch as port_batch
from platypus_tpu_torch.utils.backend import DeviceError
from torch_pool_util import (cli_args, data_lines, importers, make_dataset,
                             pool_summary, reference_lines, run_port_cli)

# Small regions, so the pool has many to share out.
SHARDS = "--bufferSize=2000"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_pool"))
    return workdir, make_dataset(workdir)


def _pool_run(tmp_path, dataset, extra, **env):
    """The port's pool over the dataset; returns (data lines, summary,
    import log lines, the run's log text)."""
    workdir, ref_path = dataset
    out = str(tmp_path / "pool.vcf")
    proc, imports = run_port_cli(
        tmp_path, cli_args(workdir, ref_path, out, [SHARDS, *extra]), **env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(f"{out}.log") as fh:
        log = fh.read()
    return data_lines(out), pool_summary(f"{out}.log"), imports, log


def test_hybrid_pool_matches_jax_and_device_worker_calls(tmp_path, dataset):
    """Two host workers and the device worker: the device worker calls
    regions (its own count, not just claims) through the port's fused
    inference, and the merged VCF equals the JAX package's single-process
    output.  On the CPU the kernel wrappers run their plain versions and
    count no launch."""
    want = reference_lines(*dataset, [SHARDS])
    got, summary, _imports, log = _pool_run(
        tmp_path, dataset, ["--nCPU=2", "--tpuWorkers=1", "--deviceInference=1"],
        PLATYPUS_TPU_DEVICE_SETTLE="0", PTT_TEST_HOST_DELAY="0.4")
    assert want and got == want
    assert summary["device"] >= 1 and summary["regions"] >= 1, summary
    assert summary["batches"] >= 1, summary
    assert summary["band_align"] == summary["band_align_tb"] == 0, summary
    assert " - ERROR - " not in log


@pytest.mark.parametrize("extra", [[], ["--calculateFlankScore=1"]],
                         ids=["default", "flank"])
def test_host_workers_import_neither_torch_nor_jax(tmp_path, dataset, extra):
    """Spawned host workers import no torch, and with jax blocked in every
    process the pool's output still equals the JAX package's: the host
    workers run the port's own host path (native alignment, the scalar
    flank path, float64 inference).  No process of the pool -- parent,
    host worker or device worker -- imports the JAX package."""
    want = reference_lines(*dataset, [SHARDS, *extra])
    got, summary, imports, _log = _pool_run(
        tmp_path, dataset, ["--nCPU=2", "--tpuWorkers=1", *extra],
        PLATYPUS_TPU_DEVICE_SETTLE="0", PTT_TEST_HOST_DELAY="0.2")
    assert want and got == want
    assert not importers(imports, "jax"), imports
    assert not importers(imports, "platypus_tpu"), imports
    torch_importers = importers(imports, "torch")
    # The guard sees the parent's and the spawned device worker's imports.
    assert {"MainProcess", "ptpu-device-worker"} <= torch_importers, imports
    assert not [name for name in torch_importers if name.startswith("ptpu-host")]
    assert summary["host"] >= 1, summary


def test_straggler_rescued_and_terminated(tmp_path, dataset):
    """The device worker claims a region and then stalls (test hook): the
    host workers rescue it, the parent terminates the straggler, and the
    output equals the JAX package's."""
    want = reference_lines(*dataset, [SHARDS])
    got, summary, _imports, log = _pool_run(
        tmp_path, dataset, ["--nCPU=2", "--tpuWorkers=1"],
        PLATYPUS_TPU_DEVICE_SETTLE="0", PTT_TEST_HOST_DELAY="0.4",
        PLATYPUS_TPU_TEST_DEVICE_DELAY="120")
    assert want and got == want
    assert summary["rescued"] >= 1 and summary["terminated"] == 1, summary
    assert "Terminating the device worker" in log


def test_device_worker_crash_fails_the_run(tmp_path, dataset):
    """A device worker that dies on its own after claiming (os._exit, test
    hook) fails the run; the JAX package would finish on the host."""
    workdir, ref_path = dataset
    out = str(tmp_path / "crash.vcf")
    proc, _ = run_port_cli(
        tmp_path, cli_args(workdir, ref_path, out,
                           [SHARDS, "--nCPU=2", "--tpuWorkers=1"]),
        PLATYPUS_TPU_DEVICE_SETTLE="0", PTT_TEST_HOST_DELAY="0.4",
        PLATYPUS_TPU_TEST_DEVICE_CRASH="1")
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "ptpu-device-worker" in proc.stderr
    assert "[17]" in proc.stderr


def test_device_worker_without_its_device_fails_the_run(tmp_path, dataset):
    """The device worker owns the run's device before claiming: on a host
    without CUDA, a cuda run's device worker exits non-zero and the run
    fails instead of finishing on the host workers."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    workdir, ref_path = dataset
    out = str(tmp_path / "nodev.vcf")
    proc, _ = run_port_cli(
        tmp_path, cli_args(workdir, ref_path, out,
                           [SHARDS, "--nCPU=2", "--tpuWorkers=1"]),
        device="cuda", PTT_TEST_HOST_DELAY="0.4")
    assert proc.returncode != 0
    assert "ptpu-device-worker" in proc.stderr, proc.stderr[-3000:]


def _fail_at(start, fn):
    """fn(chrom, start, end, ...), raising a host error for the region
    that starts at `start`."""
    def wrapped(*args, **kwargs):
        if args[1] == start:
            raise ValueError("injected host fault")
        return fn(*args, **kwargs)
    return wrapped


def _fail_state_at(start, fn):
    """fn(state, ...), raising a host error for the prepared region that
    starts at `start`."""
    def wrapped(state, *args, **kwargs):
        if state.start == start:
            raise ValueError("injected host fault")
        return fn(state, *args, **kwargs)
    return wrapped


def _fail_pairs_at(start, fn):
    """fill_deferred_pairs, raising for the requests of the region at
    `start` (found through their haplotypes' variants)."""
    def wrapped(requests):
        if any(start <= v.ref_pos < start + 2000
               for r in requests if r is not None
               for h in r.haps for v in h.variants):
            raise ValueError("injected host fault")
        return fn(requests)
    return wrapped


# stage -> (JAX package's module and name, the port's module and name);
# the first three fail in prepare, "finish" in the stage that writes
HOST_STAGES = {
    "candidates": (jax_region, port_region, "generate_variants_in_region"),
    "windows": (jax_region, port_region, "generate_windows"),
    "pair_voting": (jax_score, port_region, "fill_deferred_pairs"),
    "finish": (jax_region, port_runner, "finish_region_call"),
}


def _modes(cases):
    """Each case under the runner's two schedules: --assemble=0 (under the
    case's own id) and --assemble=1 (id suffix -assemble), whose prefetch
    helper starts before the region ahead of it is prepared."""
    return [pytest.param(case, flag, id=case + suffix)
            for case in cases
            for flag, suffix in (("--assemble=0", ""), ("--assemble=1", "-assemble"))]


class _CountedPrefetch(port_runner.RegionPrefetch):
    """The runner's RegionPrefetch, recording every helper it started."""

    started = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.started.append(self)


def _count_prefetch(monkeypatch):
    _CountedPrefetch.started.clear()
    monkeypatch.setattr(port_runner, "RegionPrefetch", _CountedPrefetch)


def _helpers_alive():
    """Prefetch helpers the run started and left running."""
    return [p for p in _CountedPrefetch.started if p._thread.is_alive()]


@pytest.mark.parametrize("stage,schedule", _modes(sorted(HOST_STAGES)))
def test_region_containment_matches_jax(tmp_path, dataset, stage, schedule,
                                        monkeypatch):
    """A host fault in one region's candidate generation, windowing, pair
    voting or finish: the JAX package logs and skips the region, and so
    does the port, under either schedule, so both VCFs agree and lack
    that region's call."""
    workdir, ref_path = dataset
    jax_mod, port_mod, name = HOST_STAGES[stage]
    start = 8999  # the 2 kb region holding the deletion at 9100
    full = reference_lines(workdir, ref_path, [SHARDS, schedule])
    jax_out, port_out = str(tmp_path / "jax.vcf"), str(tmp_path / "port.vcf")
    if stage == "pair_voting":
        inject = lambda fn: _fail_pairs_at(start, fn)  # noqa: E731
    elif stage == "finish":
        inject = lambda fn: _fail_state_at(start, fn)  # noqa: E731
    else:
        inject = lambda fn: _fail_at(start, fn)  # noqa: E731
    _count_prefetch(monkeypatch)
    with mock.patch.object(jax_mod, name, inject(getattr(jax_mod, name))):
        assert jax_cli(cli_args(workdir, ref_path, jax_out,
                                ["--deviceInference=0", SHARDS, schedule])) == 0
    with mock.patch.object(port_mod, name, inject(getattr(port_mod, name))):
        assert port_cli.main(cli_args(workdir, ref_path, port_out,
                                      ["--deviceInference=1", SHARDS, schedule]),
                             device="cpu") == 0
    want = data_lines(jax_out)
    assert data_lines(port_out) == want
    assert len(want) == len(full) - 1
    with open(f"{port_out}.log") as fh:
        log = fh.read()
    assert "Region chr20:8999-10999 will be skipped" in log
    assert log.count("will be skipped") == 1
    assert not _helpers_alive()


def _raise_cuda_error(*args, **kwargs):
    raise RuntimeError("device stage failed: CUDA error 700")


# stage -> (object, attribute) whose failure must stop the run
DEVICE_STAGES = {
    "dispatch": (port_region, "dispatch_alignment_requests"),
    "finalize": (port_score.PendingAlignments, "finalize"),
    "inference": (port_region, "dispatch_device_inference"),
    "gather": (port_batch.PendingInference, "gather"),
}


class _CountedFasta(port_runner.FastaFile):
    """The runner's FastaFile, recording which handles were left open."""

    open_handles = set()

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.open_handles.add(self)

    def close(self):
        self.open_handles.discard(self)
        super().close()


@pytest.mark.parametrize("stage,schedule", _modes(sorted(DEVICE_STAGES)))
def test_device_stage_failure_stops_the_run(tmp_path, dataset, stage, schedule,
                                            monkeypatch):
    """A failure in any device stage of the region pipeline leaves as
    DeviceError, which the region containment lets through, under either
    schedule: the run raises, no region is skipped or written, and every
    prefetch helper has ended and every FASTA handle is closed."""
    workdir, ref_path = dataset
    out = str(tmp_path / "fail.vcf")
    _count_prefetch(monkeypatch)
    monkeypatch.setattr(port_runner, "FastaFile", _CountedFasta)
    with mock.patch.object(*DEVICE_STAGES[stage], _raise_cuda_error):
        with pytest.raises(DeviceError, match="CUDA error 700"):
            port_cli.main(cli_args(workdir, ref_path, out,
                                   ["--deviceInference=1", SHARDS, schedule]),
                          device="cpu")
    with open(f"{out}.log") as fh:
        assert "will be skipped" not in fh.read()
    assert data_lines(out) == []
    assert not _CountedFasta.open_handles
    assert not _helpers_alive()


def _device_error_at(start, fn):
    """fn(state, ...), raising DeviceError for the region at `start`."""
    def wrapped(state, *args, **kwargs):
        if state.start == start:
            raise DeviceError("device stage failed: CUDA error 700")
        return fn(state, *args, **kwargs)
    return wrapped


@pytest.mark.parametrize("stage,schedule",
                         _modes(["begin_region_inference", "finish_region_call"]))
def test_device_error_stops_the_run_at_its_region(tmp_path, dataset, stage,
                                                  schedule, monkeypatch):
    """A DeviceError in one region's begin or finish, under either
    schedule: the run raises, no region after the failed one is written,
    and the regions before it are (begin k runs before finish k-2 in one
    stage, so a failed begin leaves k-1 unwritten too); the prefetch
    helper running at the fault has ended."""
    workdir, ref_path = dataset
    start = 8999  # the fifth 2 kb region
    full = reference_lines(workdir, ref_path, [SHARDS, schedule])
    last = start - 2000 if stage == "begin_region_inference" else start
    out = str(tmp_path / "fail.vcf")
    _count_prefetch(monkeypatch)
    monkeypatch.setattr(port_runner, stage,
                        _device_error_at(start, getattr(port_runner, stage)))
    with pytest.raises(DeviceError, match="CUDA error 700"):
        port_cli.main(cli_args(workdir, ref_path, out,
                               ["--deviceInference=1", SHARDS, schedule]),
                      device="cpu")
    want = [line for line in full if int(line.split("\t")[1]) <= last]
    assert want and len(want) < len(full)
    assert data_lines(out) == want
    with open(f"{out}.log") as fh:
        assert "will be skipped" not in fh.read()
    assert not _helpers_alive()


REFERENCE_HEADER = (
    "##platypusOptions={{'output': {out!r}, 'refFile': {ref!r}, "
    "'regions': ['chr20:1000-29000'], 'bamFiles': [{bam!r}], "
    "'bufferSize': 4000, 'minReads': 2, 'nCPU': 1, 'rlen': 150, "
    "'sourceFile': None, 'logFileName': {log!r}, "
    "'someUnknownRefOnlyOption': 7}}\n")


@pytest.mark.parametrize("header", ["json", "reference"])
def test_continue_calling_matches_jax(tmp_path, dataset, header):
    """continueCalling on a partial VCF cut after a middle data line: the
    port's continuation is byte-identical to the JAX package's, and its
    data lines equal the full run's (twin of test_runner.py:100, both
    header formats)."""
    workdir, ref_path = dataset
    full = str(tmp_path / "full.vcf")
    assert port_cli.main(cli_args(workdir, ref_path, full, ["--bufferSize=4000"]),
                         device="cpu") == 0
    with open(full) as fh:
        lines = fh.readlines()
    data = [i for i, line in enumerate(lines) if not line.startswith("#")]
    assert len(data) >= 3
    cut = lines[: data[len(data) // 2] + 1]
    if header == "reference":
        ref_line = REFERENCE_HEADER.format(out=full, ref=ref_path,
                                           bam=f"{workdir}/reads.bam",
                                           log=f"{full}.log")
        cut = [ref_line if line.startswith("##platypusOptions=") else line
               for line in cut]
    outs = {}
    for who, resume in (("port", "port"), ("jax", "jax")):
        partial = str(tmp_path / f"partial_{who}.vcf")
        with open(partial, "w") as fh:
            fh.writelines(cut)
        if resume == "port":
            assert port_cli.main(["continueCalling", f"--vcfFile={partial}"],
                                 device="cpu") == 0
        else:
            jax_continue(partial)
        with open(str(tmp_path / f"partial_{who}_ContinuedFromFailedProcess.vcf")) as fh:
            outs[who] = fh.read()
    assert outs["port"] == outs["jax"]
    resumed = [line for line in outs["port"].splitlines(True)
               if not line.startswith("#")]
    assert resumed == data_lines(full)


def test_continue_calling_refuses_pool_runs(tmp_path, dataset):
    workdir, ref_path = dataset
    partial = tmp_path / "pool_partial.vcf"
    cfg = PlatypusConfig(bam_files=[f"{workdir}/reads.bam"], ref_file=ref_path,
                         output=str(partial), n_cpu=2)
    partial.write_text(f"##platypusOptions={cfg.to_json()}\n")
    with pytest.raises(ValueError, match="single-process"):
        port_cli.main(["continueCalling", f"--vcfFile={partial}"], device="cpu")


def test_device_worker_policy(monkeypatch):
    """_n_device_workers keeps the JAX package's policy, keyed on the run's
    device: auto adds one device worker on CUDA with a core to spare."""
    monkeypatch.delenv("PLATYPUS_TPU_HYBRID_WORKER", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    n = port_runner._n_device_workers
    cfg = PlatypusConfig(bam_files=["x"], ref_file="y", output="z")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert n(cfg, 4, cuda) == 1
    assert n(cfg, 8, cuda) == 0          # no core to spare
    assert n(cfg, 4, cpu) == 0           # auto needs CUDA
    cfg.tpu_workers = 1
    assert n(cfg, 8, cpu) == 1           # forced
    cfg.tpu_workers = 0
    assert n(cfg, 4, cuda) == 0
    monkeypatch.setenv("PLATYPUS_TPU_HYBRID_WORKER", "1")
    assert n(cfg, 4, cpu) == 1           # the environment wins
    cfg.tpu_workers = -1
    cfg.worker_platform = "cpu"
    monkeypatch.setenv("PLATYPUS_TPU_HYBRID_WORKER", "-1")
    assert n(cfg, 4, cuda) == 0          # workers pinned by --workerPlatform
