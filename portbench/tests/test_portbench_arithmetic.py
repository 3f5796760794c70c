"""The roofline and idle-share arithmetic on hand-made inputs."""

import numpy as np

from conftest_util import tiny_cell  # noqa: F401
from portbench.harness import roofline, trace


def test_k1_operations_and_bytes():
    rl = np.array([100, 50])
    # read_len + 1 steps a pair, capped at n_steps
    assert roofline.k1_ops(rl, 108) == roofline.DP_OPS_PER_STEP * (101 + 51) \
        + 2 * roofline.K1_OPS_PER_PAIR
    assert roofline.k1_ops(np.array([200]), 108) == \
        roofline.DP_OPS_PER_STEP * 108 + roofline.K1_OPS_PER_PAIR
    # two pairs on one hap row, overlapping columns: touched once
    idx = [np.array([0, 0]), np.array([0, 1]), np.array([0, 10]),
           np.array([20, 20])]
    n = roofline.k1_bytes((1, 100), (2, 30), idx)
    hap_cols = 10 + 20 + 15  # columns 0 .. 44
    assert n == 2 * hap_cols + 2 * (20 + 20) + 5 * 4 * 2


def test_k1_bound_takes_the_larger_side():
    idx = [np.zeros(1, np.int64)] * 3 + [np.array([100])]
    clock = 1e9
    t = roofline.k1_bound_s((1, 200), (1, 100), idx, clock)
    ops = roofline.k1_ops(np.array([100]), 108) / (64 * clock)
    assert t == max(ops, roofline.k1_bytes((1, 200), (1, 100), idx) / 3.35e12)


def test_k3_work_counts_each_window():
    from platypus_tpu_torch.ops.likelihood import genotype_index_pairs

    h1, h2 = (np.asarray(a, np.int32) for a in genotype_index_pairs(2))
    ll = np.full((1, 2, 4), -1.0, np.float32)
    ll[0, 1] = -2.0                         # |diff| = 1: the exact branch
    oh = np.ones((1, 1, 4), np.float32)
    hm = np.ones((1, 2), bool)
    vm = np.zeros((1, 1, 2), bool)
    hr = np.ones((1, 1), bool)
    n_bytes, mufu, flops = roofline.k3_work([ll, oh, hm, h1, h2, vm, hr],
                                            np.array([3]))
    assert n_bytes == sum(a.nbytes for a in (ll, oh, hm, h1, h2, vm, hr)) \
        + 4 * (4 * 1 * 1 * 3 + 2 + 1 + 1)
    # 4 exact reads of the het genotype (2 each), n*Gw GL exps, 3 EM
    # iterations, the outputs (no variant)
    assert mufu == 2 * 4 + 3 + 3 * (2 * 3 + 1 + 3 + 4 + 6) + 3 + 2 + 4
    assert flops > 0


def _ev(name, cat, ts, dur, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, args=args)


def test_busy_is_the_union_inside_the_window_and_gaps_are_labelled():
    events = [
        _ev(trace.WINDOW, "user_annotation", 100, 1000),
        _ev("portbench.prepare_region_call", "user_annotation", 100, 500),
        _ev("portbench.finish_region_call", "user_annotation", 600, 500),
        _ev("k", "kernel", 50, 100, device=0),       # 100 of it inside
        _ev("k", "kernel", 120, 80, device=0),       # overlaps the first
        _ev("HtoD", "gpu_memcpy", 700, 100, device=0),
        _ev("late", "kernel", 1050, 100, device=0),  # 50 inside
    ]
    s = trace.summarize(events, spans=("portbench.prepare_region_call",
                                       "portbench.finish_region_call"))
    assert s["window_s"] == 1000e-6
    assert abs(s["busy_s"] - 250e-6) < 1e-12
    assert {k: round(v * 1e6) for k, v in s["kernel_s"].items()} == {
        "k": 130, "late": 50}
    labels = {name: round(sec * 1e6) for name, sec in s["idle_gaps"]}
    assert labels == {"portbench.prepare_region_call": 500,
                      "portbench.finish_region_call": 250}


def test_a_window_without_device_work_is_one_gap():
    events = [_ev(trace.WINDOW, "user_annotation", 0, 100),
              _ev("k", "kernel", 200, 40, device=0)]  # after the window
    s = trace.summarize(events)
    assert s["busy_s"] == 0 and s["kernel_s"] == {}
    assert s["idle_gaps"] == [["other", 100e-6]]
