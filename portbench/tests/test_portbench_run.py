"""A whole run of the harness on the CPU at a tiny size (the harness's
look for a card skipped): sound, it is correct; with the control in K3's
place, or with a fault planted under the timed path, it is not.  And
run.py without a card prints no result."""

import os
import subprocess
import sys
import time

import pytest
import torch

from conftest_util import ROOT, run_tiny, tiny_cell
from portbench.harness.core import run_cell


def test_sound_run_is_correct_and_reports_its_metrics():
    r = run_tiny("wgs")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-2:] == ["readings", "checks"]


def test_traced_cohort_run_is_correct():
    r = run_tiny("cohort", trace=True)
    assert r["correct"], r["checks"]
    assert "prep_s_per_mreads" in r["metrics"]
    assert "k1_roofline" not in r["metrics"]  # no card: nothing to read


def test_a_null_limit_is_a_reading_and_not_compared():
    cell = tiny_cell("wgs")
    cell.limits["extra_per_mb"] = None
    r = run_cell(cell, 2**33 + 7, 1.0, False, time.perf_counter(),
                 device=torch.device("cpu"), overrides={"device_inference": 1})
    assert "extra_per_mb" in r["readings"]
    assert "extra_per_mb" not in r["checks"]
    assert "missed_share" in r["checks"]


def test_bf16_control_is_not_correct():
    r = run_tiny("cohort", substitute="bf16")
    assert not r["correct"]
    assert r["checks"]["k3_post_gap"]["value"] > r["checks"]["k3_post_gap"]["limit"]


@pytest.mark.parametrize("kind,fault", [
    ("cohort", "k1_altered"),
    ("cohort", "k3_unchanged"),
    ("cohort", "k3_half"),
    ("cohort", "candidates_half"),
    ("wgs", "genotype_altered"),
])
def test_planted_fault_is_not_correct(kind, fault):
    r = run_tiny(kind, substitute=fault)
    assert not r["correct"], r["checks"]


def test_substitutes_are_taken_out_after_the_run():
    import importlib

    from portbench.harness.faults import SUBSTITUTES

    before = {n: getattr(importlib.import_module(m), a)
              for n, (m, a, _f) in SUBSTITUTES.items()}
    run_tiny("cohort", seconds=0.5, substitute="k3_half")
    assert before == {n: getattr(importlib.import_module(m), a)
                      for n, (m, a, _f) in SUBSTITUTES.items()}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "wgs1_30x", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_sound_run_on_the_card_is_correct(card):
    r = run_cell(tiny_cell("cohort"), 2**33 + 9, 2.0, False,
                 time.perf_counter(), device=card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
