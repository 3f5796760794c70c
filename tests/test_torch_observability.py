"""The torch port's observability: trace() (PLATYPUS_TPU_TRACE_DIR, the
counterpart of platypus_tpu/utils/observability.py:73-83 on
torch.profiler) and the thread-safe Metrics."""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import pytest
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


def test_trace_inside_a_running_session_adds_none(tmp_path, monkeypatch):
    """A trace entered inside another (the CLI's callVariants trace under a
    caller's own) starts no second profiler session: the outer one ends
    cleanly and writes the only Chrome trace, holding the inner body."""
    monkeypatch.setenv("PLATYPUS_TPU_TRACE_DIR", str(tmp_path))
    with observability.trace("outer"):
        with observability.trace("inner"):
            torch.arange(8).sum()
    assert sorted(os.listdir(tmp_path)) == ["outer"]
    files = glob.glob(str(tmp_path / "outer" / "*.pt.trace.json"))
    with open(files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::sum" in names


def test_metrics_counts_from_eight_threads_add_up():
    """timer and count from 8 threads at once lose no update."""
    metrics = Metrics()
    n, start = 2000, threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(n):
            metrics.count("calls")
            metrics.count("pairs", 3)
            with metrics.timer("timed"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert metrics.counters["calls"] == 8 * n
    assert metrics.counters["pairs"] == 3 * 8 * n
    assert metrics.timers["timed"] > 0
    assert "calls=16000" in metrics.summary()
    metrics.reset()
    assert metrics.summary() == ""


def test_spans_from_sixteen_threads_lose_no_update():
    """Sixteen threads (more than the cores), switching every 10 us, each
    open 500 spans three deep: every span reaches the totals and the
    helper self times (each name's self seconds sum to its total less its
    child's), and no thread's stack is left behind."""
    metrics = Metrics()
    n, start = 500, threading.Barrier(16)
    ends = []

    def work():
        start.wait()
        for _ in range(n):
            with metrics.timer("outer", region="c:1-2"):
                with metrics.timer("middle"):
                    with metrics.timer("inner") as span:
                        pass
            ends.append(span.end)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(ends) == 16 * n
    snap = metrics.snapshot()
    timers, helper = snap["timers"], snap["self_times"]["helper"]
    assert snap["self_times"]["pipeline"] == {}
    assert helper["inner"] == pytest.approx(timers["inner"])
    assert helper["middle"] == pytest.approx(timers["middle"] - timers["inner"])
    assert helper["outer"] == pytest.approx(timers["outer"] - timers["middle"])
    assert metrics._stacks == {}
