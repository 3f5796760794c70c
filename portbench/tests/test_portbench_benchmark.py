"""BENCHMARK.json keeps the contract's names and units, and every cell's
files are found by name."""

import importlib
import json
import os
import re

from conftest_util import ROOT
from portbench.harness.core import HERE, load_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("end_to_end", "per_layer"):
        for m in BENCH[k]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")


def test_every_cell_finds_its_files():
    metric_names = {m["name"] for k in ("end_to_end", "per_layer")
                    for m in BENCH[k]}
    for m in metric_names:
        assert callable(importlib.import_module(f"portbench.metrics.{m}").read)
    for w in BENCH["workloads"]:
        for trace in (False, True):
            cell = load_cell(ROOT, w["name"], trace)
            assert cell.metrics
            gen = importlib.import_module(
                f"portbench.traffic.{cell.traffic['generator']}")
            assert callable(gen.build)
            assert set(cell.limits) >= {"k1_mismatches", "k3_gl_gap",
                                        "k3_post_gap", "missed_share"}
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg)
        assert os.path.commonpath([os.path.abspath(os.path.join(ROOT, c["file"])),
                                   HERE]) == HERE


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
