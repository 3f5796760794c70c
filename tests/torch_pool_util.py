"""Shared helpers of the torch port's multi-process tests
(test_torch_pool.py, test_torch_service.py, test_torch_mesh.py,
test_torch_distributed.py).

The port's CLI runs in a fresh interpreter on device="cpu", so the pool's
spawned processes start from a clean environment.  A `sitecustomize.py`
on that interpreter's PYTHONPATH, loaded by every process of the pool,
does what the tests need there:

* it logs each first `import torch` and each first `import platypus_tpu`
  (the JAX package) with the name of the process that made it, and blocks
  (and logs) every `import jax`, to PTT_TEST_IMPORT_LOG; with
  PTT_TEST_BLOCK_JAX_PACKAGE=1 it blocks `import platypus_tpu` too;
* with PTT_TEST_HOST_DELAY=s, the host workers' main pass (the port's
  run_single_process on device None over the claim source) waits until
  the device worker has finished its first region (or for two minutes),
  then sleeps s seconds before each region it claims, so the device
  worker's start-up cannot lose it every region.  The device worker
  signals by creating the file PTT_TEST_DEVICE_RELEASED after its first
  region is written; held by the straggler hook
  (PLATYPUS_TPU_TEST_DEVICE_DELAY), it creates the file when it starts to
  stall, since it will not finish one;
* with PTT_TEST_SERVICE_FAIL=1, the port's launch_fused_inference raises,
  so the device-owner service records a dispatch error.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys

from platypus_tpu.cli import main as jax_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION = "--regions=chr20:1000-29000"

SITECUSTOMIZE = '''
import importlib.abc
import multiprocessing
import os
import sys

_LOG = os.environ.get("PTT_TEST_IMPORT_LOG")


def _note(what):
    with open(_LOG, "a") as fh:
        fh.write(f"{what} {multiprocessing.current_process().name}\\n")


class _Guard(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith("jax."):
            _note("jax")
            raise ImportError("jax is blocked in this process")
        if name == "platypus_tpu":
            _note("platypus_tpu")
            if os.environ.get("PTT_TEST_BLOCK_JAX_PACKAGE"):
                raise ImportError("platypus_tpu is blocked in this process")
        if name == "torch":
            _note("torch")
        return None


if _LOG:
    sys.meta_path.insert(0, _Guard())

if os.environ.get("PTT_TEST_HOST_DELAY"):
    import time

    import platypus_tpu_torch.engine.runner as _runner

    _run = _runner.run_single_process
    _RELEASED = os.environ["PTT_TEST_DEVICE_RELEASED"]

    def _release():
        open(_RELEASED, "a").close()

    def _slow(regions, delay):
        # Hold the first claim until the device worker has released the
        # host workers, then claim at most one region per `delay`.
        deadline = time.monotonic() + 120
        while not os.path.exists(_RELEASED) and time.monotonic() < deadline:
            time.sleep(0.05)
        for region in regions:
            time.sleep(delay)
            yield region

    def _releasing(on_done):
        def done(region):
            if on_done is not None:
                on_done(region)
            _release()
        return done

    def _slow_run(config, regions, output_path, device, *args, **kwargs):
        if device is not None:
            kwargs["on_region_done"] = _releasing(kwargs.get("on_region_done"))
            return _run(config, regions, output_path, device, *args, **kwargs)
        if isinstance(regions, _runner.RegionClaimSource):
            # a host worker's main pass (its rescue pass runs a list)
            regions = _slow(regions, float(os.environ["PTT_TEST_HOST_DELAY"]))
        return _run(config, regions, output_path, device, *args, **kwargs)

    def _stalling(regions, delay):
        for region in regions:
            _release()
            time.sleep(delay)
            yield region

    _runner.run_single_process = _slow_run
    _runner._delayed_regions = _stalling

if os.environ.get("PTT_TEST_SERVICE_FAIL"):
    from platypus_tpu_torch.parallel import batch as _batch

    def _failing_launch(*args, **kwargs):
        raise RuntimeError("fused inference launch failed: CUDA error 700")

    _batch.launch_fused_inference = _failing_launch
'''


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the enclosed test with TimeoutError after `seconds` (SIGALRM,
    so only in the main thread) instead of letting it hang the run."""
    def expire(_sig, _frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def make_dataset(workdir):
    """test_device_service.py's 30 kb dataset; returns the reference path."""
    from test_device_service import _make_dataset

    if not os.path.exists(os.path.join(workdir, "reads.bam")):
        return _make_dataset(workdir)
    return os.path.join(workdir, "ref.fa")


def cli_args(workdir, ref_path, out, extra=(), region=REGION):
    return ["callVariants", f"--bamFiles={workdir}/reads.bam",
            f"--refFile={ref_path}", region, f"--logFileName={out}.log",
            *extra, "-o", out]


def data_lines(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def reference_lines(workdir, ref_path, extra=(), region=REGION):
    """Data lines of the JAX package's single-process CPU run (native
    kernels, float64 host inference), run in this process once per
    (extra, region)."""
    tag = "_".join(a.strip("-").replace("=", "") for a in (*extra, region))
    out = os.path.join(workdir, f"jax_{tag}.vcf")
    if not os.path.exists(out):
        assert jax_cli(cli_args(workdir, ref_path, out,
                                ["--deviceInference=0", *extra], region)) == 0
    return data_lines(out)


def fresh_env(tmp_path, **env_set):
    """The environment of a fresh interpreter that loads the test
    sitecustomize (jax blocked, torch and platypus_tpu imports logged),
    with env_set laid
    over this one's.  Returns (environment, import log path)."""
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    import_log = tmp_path / "imports.log"
    import_log.write_text("")
    released = tmp_path / "device_released"
    if released.exists():
        released.unlink()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PLATYPUS_TPU_PLATFORM", "JAX_PLATFORMS")}
    env.update(env_set)
    env["PYTHONPATH"] = os.pathsep.join([str(site), REPO])
    env["PTT_TEST_IMPORT_LOG"] = str(import_log)
    env["PTT_TEST_DEVICE_RELEASED"] = str(released)
    return env, import_log


def run_port_cli(tmp_path, argv, device="cpu", **env_set):
    """The port's CLI, main(argv, device), in a fresh interpreter with the
    test sitecustomize loaded; env_set is laid over this environment.
    Returns (CompletedProcess, the import log's lines)."""
    env, import_log = fresh_env(tmp_path, **env_set)
    code = ("import sys\n"
            "from platypus_tpu_torch.cli import main\n"
            f"sys.exit(main({list(argv)!r}, device={device!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc, import_log.read_text().splitlines()


def importers(imports, what):
    """Names of the processes whose first import of `what` (torch, jax or
    platypus_tpu) the import log holds."""
    return {line.split()[1] for line in imports if line.split()[0] == what}


def pool_summary(log_path):
    """The pool's summary line (engine/runner.py run_pool) from a run's
    log file, as a dict."""
    with open(log_path) as fh:
        lines = [line for line in fh if " - pool: " in line]
    assert lines, f"no pool summary in {log_path}"
    return json.loads(lines[-1].split(" - pool: ", 1)[1])
