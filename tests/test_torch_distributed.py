"""The torch port's multi-host run (platypus_tpu_torch/parallel/distributed.py)
on the CPU: two real processes over a gloo group, each in a fresh
interpreter with jax blocked, against the CPU-pinned JAX package's
single-process run of the same regions.

Twin of tests/test_distributed_live.py:31, in the three ways a run starts:
run_distributed called with the coordinator's address, the module's own
command line (`python -m platypus_tpu_torch.parallel.distributed`), and
the port's CLI with --distributed=1 under torchrun's environment.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.parallel import distributed as port_dist
from torch_pool_util import (REGION, REPO, cli_args, data_lines, fresh_env,
                             importers, make_dataset, reference_lines,
                             time_limit)

# Seven regions, shared out round-robin between the two processes.
SHARDS = "--bufferSize=4000"


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(150):
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_dist"))
    ref_path = make_dataset(workdir)
    return workdir, ref_path, reference_lines(workdir, ref_path, [SHARDS])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, code_of, env_of=lambda rank: {}):
    """Run `python -c code_of(rank)` for ranks 0 and 1 together, each in a
    fresh interpreter with jax blocked; returns their stdouts."""
    env, import_log = fresh_env(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", code_of(rank)], cwd=REPO,
                              env=dict(env, **env_of(rank)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    imports = import_log.read_text().splitlines()
    assert not importers(imports, "jax") and not importers(imports, "platypus_tpu")
    return outs


def test_two_processes_match_the_single_process_run(tmp_path, dataset):
    """run_distributed in two processes: the merged VCF's data lines are
    the JAX package's single-process lines, and aggregate_metrics sums
    asymmetric keys over both."""
    workdir, ref_path, want = dataset
    port = _free_port()
    out = str(tmp_path / "dist.vcf")

    def code(rank):
        return f"""
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.parallel.distributed import (aggregate_metrics,
                                                     run_distributed, shutdown)

cfg = PlatypusConfig(bam_files=[{workdir + '/reads.bam'!r}],
                     ref_file={ref_path!r}, regions=[{REGION.split('=')[1]!r}],
                     buffer_size=4000, output={out!r})
run_distributed(cfg, "cpu", coordinator_address="127.0.0.1:{port}",
                num_processes=2, process_id={rank})
totals = aggregate_metrics({{"reads": 10.0 * ({rank} + 1), "only{rank}": 1.5}})
print("TOTALS", sorted(totals.items()))
shutdown()
"""

    outs = _run_pair(tmp_path, code)
    expect = "TOTALS [('only0', 1.5), ('only1', 1.5), ('reads', 30.0)]"
    for text in outs:
        assert expect in text, text
    assert want and data_lines(out) == want
    assert not os.path.exists(f"{out}_host0") and not os.path.exists(f"{out}_host1")


def test_module_command_line(tmp_path, dataset):
    """`python -m platypus_tpu_torch.parallel.distributed callVariants ...
    --coordinatorAddress --numProcesses --processId`, as its _main, which
    leaves the process group before it returns."""
    workdir, ref_path, want = dataset
    port = _free_port()
    out = str(tmp_path / "dist_cli.vcf")

    def code(rank):
        argv = [*cli_args(workdir, ref_path, out, [SHARDS]),
                f"--coordinatorAddress=127.0.0.1:{port}", "--numProcesses=2",
                f"--processId={rank}"]
        return ("import torch.distributed as dist\n"
                "from platypus_tpu_torch.parallel.distributed import _main\n"
                f"rc = _main({argv!r}, device='cpu')\n"
                "assert not dist.is_initialized(), 'the group is still up'\n"
                "raise SystemExit(rc)\n")

    _run_pair(tmp_path, code)
    assert data_lines(out) == want


def test_port_cli_under_torchrun_environment(tmp_path, dataset):
    """The port's CLI with --distributed=1 reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK, as torchrun sets them, and leaves the process
    group before it returns."""
    workdir, ref_path, want = dataset
    port = _free_port()
    out = str(tmp_path / "dist_torchrun.vcf")
    argv = cli_args(workdir, ref_path, out, [SHARDS, "--distributed=1"])

    def env_of(rank):
        return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))

    code = ("import torch.distributed as dist\n"
            "from platypus_tpu_torch.cli import main\n"
            f"rc = main({argv!r}, device='cpu')\n"
            "assert not dist.is_initialized(), 'the group is still up'\n"
            "raise SystemExit(rc)\n")
    _run_pair(tmp_path, lambda rank: code, env_of)
    assert data_lines(out) == want


def test_world_of_one_needs_no_group(tmp_path, dataset, monkeypatch):
    """Without a coordinator or torchrun's environment the run is one
    process: no process group, config.output written directly, metrics
    and barrier the identity."""
    workdir, ref_path, want = dataset
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    out = str(tmp_path / "one.vcf")
    cfg = PlatypusConfig(bam_files=[f"{workdir}/reads.bam"], ref_file=ref_path,
                         regions=[REGION.split("=")[1]], buffer_size=4000,
                         output=out, distributed=1)
    port_dist.run_distributed(cfg, "cpu")
    assert not dist.is_initialized()
    assert data_lines(out) == want
    assert port_dist.initialize() == (0, 1)
    assert port_dist.aggregate_metrics({"a": 2.0}) == {"a": 2.0}
    port_dist.barrier()


def test_rank_device(monkeypatch):
    """cuda (no index) or None becomes cuda:{LOCAL_RANK % device_count};
    an explicit device stays as given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert port_dist.rank_device(None) == torch.device("cuda", 1)
    assert port_dist.rank_device("cuda") == torch.device("cuda", 1)
    assert port_dist.rank_device("cuda:0") == torch.device("cuda", 0)
    assert port_dist.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dist.rank_device(None)


def test_several_processes_need_a_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        port_dist.initialize(num_processes=2, process_id=0)
    assert not dist.is_initialized()
