"""The torch port's fused window inference
(platypus_tpu_torch/ops/likelihood_torch.py) against the JAX one
(platypus_tpu/ops/likelihood_jax.py) and the float64 host oracle.

Port vs JAX tolerance: rtol 1e-4 / atol 1e-5 on lik, em, freq, gof and
gl_rel; atol 1e-3 on ratios and 1e-5 on em_margin.  Both run the same f32
algorithm; only the order of summation differs (torch's reductions and
matmul against XLA's), so the outputs agree to a few f32 ulps of the
accumulated sums.  Port vs host oracle uses test_device_inference.py's
tolerances."""

import numpy as np
import pytest
import torch

from platypus_tpu.ops import likelihood as lk
from platypus_tpu.ops.likelihood_jax import infer_window_batch as jax_infer
from platypus_tpu.ops.likelihood_jax import scores_to_logliks_jax
from platypus_tpu_torch.ops.likelihood_torch import (infer_window_batch,
                                                     scores_to_logliks)
from test_device_inference import _host_reference, _random_window

CASES = [(2, 30, 1), (3, 55, 2), (5, 17, 3)]   # test_device_inference.py:59
NAMES = ("lik", "em", "freq", "gof", "ratios", "gl_rel", "em_margin")


def _batch(windows, I, pad_h=1, pad_r=4):
    """Pad windows [(loglik, sample_idx, is_good, var_masks)] of I
    individuals into one batch (plus one empty window row)."""
    Hb = max(w[0].shape[0] for w in windows) + pad_h
    Rb = max(w[0].shape[1] for w in windows) + pad_r
    Vb = max(len(w[3]) for w in windows) + 1
    Wb = len(windows) + 1
    ll = np.zeros((Wb, Hb, Rb), np.float32)
    oh = np.zeros((Wb, I, Rb), np.float32)
    hm = np.zeros((Wb, Hb), bool)
    vm = np.zeros((Wb, Vb, Hb), bool)
    hr = np.zeros((Wb, I), bool)
    for k, (loglik, sample_idx, is_good, var_masks) in enumerate(windows):
        H, R = loglik.shape
        ll[k, :H, :R] = loglik
        oh[k, sample_idx, np.arange(R)] = 1.0
        hm[k, :H] = True
        for vi, m in enumerate(var_masks):
            vm[k, vi, :H] = m
        n_good = np.bincount(sample_idx[is_good], minlength=I)
        hr[k] = n_good > 0
    h1, h2 = lk.genotype_index_pairs(Hb)
    return ll, oh, hm, h1.astype(np.int32), h2.astype(np.int32), vm, hr


def _run_both(arrays):
    want = [np.asarray(a) for a in jax_infer(*arrays, em_iters=100)]
    got = [t.numpy() for t in infer_window_batch(
        *(torch.from_numpy(a) for a in arrays), em_iters=100)]
    return got, want


def _assert_port_matches_jax(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "ratios":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=name)
        elif name == "em_margin":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def _case_window(H, R, I):
    rng = np.random.default_rng(42 + H)
    loglik, sample_idx, is_good = _random_window(rng, H, R, I)
    var_masks = [rng.random(H) < 0.5 for _ in range(2)]
    for m in var_masks:
        m[0] = False  # ref hap never carries the variant
    return loglik, sample_idx, is_good, var_masks


@pytest.mark.parametrize("H,R,I", CASES)
def test_infer_window_batch_matches_jax(H, R, I):
    arrays = _batch([_case_window(H, R, I)], I, pad_h=2, pad_r=10)
    _assert_port_matches_jax(*_run_both(arrays))


@pytest.mark.parametrize("H,R,I", CASES)
def test_infer_window_batch_matches_host_oracle(H, R, I):
    window = _case_window(H, R, I)
    loglik, sample_idx, is_good, var_masks = window
    host_lik, host_em, host_freq, host_gof, _n, host_ratio = _host_reference(
        loglik, sample_idx, is_good, I, var_masks)
    arrays = _batch([window], I, pad_h=2, pad_r=10)
    lik, em, freq, gof, ratio, glrel, margin = (t.numpy() for t in infer_window_batch(
        *(torch.from_numpy(a) for a in arrays), em_iters=100))
    h1b, h2b = arrays[3], arrays[4]
    cols = np.nonzero((h1b < H) & (h2b < H))[0]
    assert margin[0] >= 0.0
    np.testing.assert_allclose(lik[0][:, cols], host_lik, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.exp(glrel.astype(np.float64))[0][:, cols],
                               host_lik, rtol=1e-3, atol=1e-290)
    np.testing.assert_allclose(freq[0][:H], host_freq, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(em[0][:, cols], host_em, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(gof[0][:, cols], host_gof, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(ratio[0][: len(var_masks)], host_ratio,
                               rtol=5e-3, atol=0.25)
    # The padded window row stays finite and silent.
    assert np.isfinite(freq[-1]).all()
    assert ratio[-1].tolist() == [0.0] * ratio.shape[1]


def _guard_loop_windows(n=30):
    """The first n random windows of test_device_inference.py:159's loop
    (same generator, same draws), grouped by individual count."""
    rng = np.random.default_rng(123)
    by_i = {}
    for _ in range(n):
        H = int(rng.integers(2, 6))
        R = int(rng.integers(8, 60))
        I = int(rng.integers(1, 4))
        loglik, sample_idx, is_good = _random_window(rng, H, R, I)
        V = int(rng.integers(1, 3))
        var_masks = [rng.random(H) < 0.5 for _ in range(V)]
        for m in var_masks:
            m[0] = False
        by_i.setdefault(I, []).append((loglik, sample_idx, is_good, var_masks))
    return sorted(by_i.items())


@pytest.mark.parametrize("I", [1, 2, 3])
def test_random_windows_match_jax(I):
    windows = dict(_guard_loop_windows())[I]
    assert windows
    _assert_port_matches_jax(*_run_both(_batch(windows, I)))


@pytest.mark.parametrize("use_map_qual_cap", [False, True])
def test_scores_to_logliks_matches_jax(use_map_qual_cap):
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 400, size=(4, 50)).astype(np.float32)
    mapq = rng.integers(0, 61, size=(1, 50)).astype(np.float32)
    want = np.asarray(scores_to_logliks_jax(scores, mapq,
                                            use_map_qual_cap=use_map_qual_cap))
    got = scores_to_logliks(torch.from_numpy(scores), torch.from_numpy(mapq),
                            use_map_qual_cap=use_map_qual_cap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_em_freezes_converged_windows():
    """Windows that converge at different iterations share one batch: the
    port's masked loop must leave each as if it had run alone."""
    windows = dict(_guard_loop_windows())[2][:3]
    ll, oh, hm, h1, h2, vm, hr = _batch(windows, 2)

    def run(sl):
        return infer_window_batch(*(torch.from_numpy(a) for a in (
            ll[sl], oh[sl], hm[sl], h1, h2, vm[sl], hr[sl])))

    together = run(slice(None))
    for k in range(len(windows)):
        alone = run(slice(k, k + 1))
        for name, t_all, t_one in zip(NAMES, together, alone):
            np.testing.assert_allclose(t_all[k].numpy(), t_one[0].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
