"""The torch port's observability: trace() (PLATYPUS_TPU_TRACE_DIR, the
counterpart of platypus_tpu/utils/observability.py:73-83 on
torch.profiler) and the thread-safe Metrics."""

import glob
import json
import os
import subprocess
import sys
import threading

import torch

from platypus_tpu_torch.utils import observability
from platypus_tpu_torch.utils.observability import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_without_the_variable_is_a_no_op(tmp_path):
    """No PLATYPUS_TPU_TRACE_DIR: the body runs, nothing is written, and a
    fresh interpreter that enters trace() imports no torch."""
    code = ("import os, sys\n"
            "from platypus_tpu_torch.utils.observability import trace\n"
            "ran = []\n"
            "with trace('label'):\n"
            "    ran.append(1)\n"
            "assert ran == [1]\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n"
            "assert os.listdir('.') == []\n")
    env = {k: v for k, v in os.environ.items() if k != "PLATYPUS_TPU_TRACE_DIR"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_per_label(tmp_path, monkeypatch):
    """With the variable set, on the CPU: <dir>/<label>/ holds one
    *.pt.trace.json whose events include the body's aten:: ops."""
    monkeypatch.setenv("PLATYPUS_TPU_TRACE_DIR", str(tmp_path))
    with observability.trace("region"):
        a = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "region" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"aten::arange", "aten::matmul", "aten::sum"} <= names
    assert os.listdir(tmp_path) == ["region"]


def test_metrics_counts_from_eight_threads_add_up():
    """timer, add and count from 8 threads at once lose no update."""
    metrics = Metrics()
    n, start = 2000, threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(n):
            metrics.count("calls")
            metrics.count("pairs", 3)
            metrics.add("stage", 1.0)
            with metrics.timer("timed"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert metrics.counters["calls"] == 8 * n
    assert metrics.counters["pairs"] == 3 * 8 * n
    assert metrics.timers["stage"] == 8 * n
    assert metrics.timers["timed"] > 0
    assert "calls=16000" in metrics.summary()
    metrics.reset()
    assert metrics.summary() == ""
