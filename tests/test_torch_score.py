"""The torch port's batched pair alignment (platypus_tpu_torch/engine/score.py)
against the JAX package's on a synthetic region, each package preparing
the region through its own host code: the per-window [H, R] float64
log-likelihood matrices must be np.array_equal, and in flank mode every
pair's flank-corrected score equals the JAX package's scalar path."""

import dataclasses

import numpy as np
import pytest
import torch

from platypus_tpu.engine import score as jax_score
from platypus_tpu_torch.engine import score as port_score
from platypus_tpu_torch.ops import align_cuda
from torch_twin_util import JAX_PKG, PORT_PKG, prepare

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """One synthetic region (SNPs, an insertion, a deletion; 30x, 100 bp
    reads) prepared by each package's host code: per package, its live
    windows and their [H, R] log-likelihoods from its native path (the
    port's host path)."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    workdir = str(tmp_path_factory.mktemp("torch_score"))
    ref_path, ref_seq = make_reference(workdir, length=12000, seed=11)
    variants = [(3000, 1, b"A" if ref_seq[3000] != ord("A") else b"C"),
                (3012, 1, b"G" if ref_seq[3012] != ord("G") else b"T"),
                (6100, 3, b""),
                (9050, 0, b"TTA")]
    reads = simulate_reads([SimHaplotype(ref_seq, variants),
                            SimHaplotype(ref_seq, [])], 1000, 11000,
                           coverage=30, error_rate=0.002, seed=5,
                           fast_errors=True)
    bam = write_synth_bam(workdir, reads, ref_len=12000)
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        prep = prepare(pkg, ("chr20", 1000, 11000), bam_files=[bam],
                       ref_file=ref_path, output="-")
        live = prep.state.live
        logliks = prep.state.pending.finalize()
        out[pkg] = (live, {w_idx: ll for (w_idx, _p), ll in zip(live, logliks)})
        prep.close()
    assert [w for w, _ in out[JAX_PKG][0]] == [w for w, _ in out[PORT_PKG][0]]
    for w_idx, ll in out[JAX_PKG][1].items():
        assert np.array_equal(out[PORT_PKG][1][w_idx], ll)
    return out


def _requests(live):
    requests = [p.request for _, p in live]
    assert sum(r.n_pairs() for r in requests if r is not None) > 300
    return requests


@pytest.fixture(scope="module")
def region_requests(region):
    """Every live window's AlignmentRequest, as the port built it."""
    return _requests(region[PORT_PKG][0])


@pytest.fixture(scope="module")
def jax_requests(region):
    """The same windows' AlignmentRequests, as the JAX package built them."""
    return _requests(region[JAX_PKG][0])


@pytest.mark.parametrize("jax_align", ["native", "xla"])
def test_finalize_matches_jax_package(region_requests, jax_requests, jax_align,
                                      monkeypatch):
    """Port (plain DP on CPU tensors) == JAX package, whether the JAX
    package aligns with its native AVX2 kernel or its XLA scan."""
    monkeypatch.setenv("PLATYPUS_TPU_NATIVE_ALIGN",
                       "1" if jax_align == "native" else "0")
    want = jax_score.dispatch_alignment_requests(jax_requests).finalize()
    got = port_score.dispatch_alignment_requests(region_requests, CPU).finalize()
    assert len(got) == len(want) == len(region_requests)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        assert np.array_equal(g, w)


def test_lane_chunking_and_padding(region_requests, monkeypatch):
    """Small lane buckets force many chunks and a padded last chunk: the
    matrices must not change, and no kernel launch is counted on CPU."""
    want = port_score.dispatch_alignment_requests(region_requests, CPU).finalize()
    monkeypatch.setattr(port_score, "LANE_BUCKETS", (16, 64))
    before = dict(align_cuda.LAUNCHES)
    pending = port_score.dispatch_alignment_requests(region_requests, CPU)
    assert sum(len(chunks) for _, _, chunks in pending.groups) > 4
    got = pending.finalize()
    assert align_cuda.LAUNCHES == before
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_host_path_matches_jax_package(region_requests, jax_requests):
    """The port's host path (device None: the native library it builds
    from its own sources) == the JAX package's native path."""
    want = jax_score.dispatch_alignment_requests(jax_requests).finalize()
    pending = port_score.dispatch_alignment_requests(region_requests, None)
    assert pending.groups and not any(chunks for _, _, chunks in pending.groups)
    got = pending.finalize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("device", [CPU, None], ids=["cpu", "host"])
def test_score_reads_vs_haplotypes_matches_jax_package(region_requests,
                                                       jax_requests, device):
    k = next(i for i, r in enumerate(region_requests)
             if r is not None and len(r.haps) > 1)
    req, jreq = region_requests[k], jax_requests[k]
    want = jax_score.score_reads_vs_haplotypes(jreq.haps, jreq.reads)
    got = port_score.score_reads_vs_haplotypes(req.haps, req.reads, device)
    assert got.shape == (len(req.haps), len(req.reads))
    assert np.array_equal(got, want)


def _flank_copies(requests):
    """Flank-mode copies of the first live windows' requests (> 300 pairs;
    the scalar flank path costs ~6 ms per pair)."""
    out = []
    for req in requests:
        if req is not None and req.n_pairs():
            out.append(dataclasses.replace(req, calculate_flank_score=True))
        if sum(r.n_pairs() for r in out) > 300:
            return out
    raise AssertionError("the region has too few pairs")


@pytest.fixture(scope="module")
def flank_requests(region_requests):
    return _flank_copies(region_requests)


@pytest.fixture(scope="module")
def jax_flank_requests(jax_requests):
    return _flank_copies(jax_requests)


def test_flank_dispatch_matches_jax_scalar_path(flank_requests,
                                                jax_flank_requests, monkeypatch):
    """The port's flank dispatch (plain traceback DP + host backtrace) ==
    the JAX package's _scalar_flank_scores pair for pair, and so is the
    port's own scalar path (the host path's); the [H, R] matrices of both
    finalizes are equal; the pairs the flank penalty lowered are
    counted."""
    monkeypatch.setenv("PLATYPUS_TPU_DEVICE_FLANK", "0")
    jax_pending = jax_score.dispatch_alignment_requests(jax_flank_requests)
    want = jax_pending.finalize()
    pending = port_score.dispatch_alignment_requests(flank_requests, CPU)
    assert len(pending.flank_groups) == 1 and not pending.groups
    lowered = port_score.metrics.counters["flank_pairs_lowered"]
    got = pending.finalize()
    lowered = port_score.metrics.counters["flank_pairs_lowered"] - lowered
    assert 0 < lowered <= sum(r.n_pairs() for r in flank_requests)
    plain = port_score.dispatch_alignment_requests(
        [dataclasses.replace(r, calculate_flank_score=False)
         for r in flank_requests], CPU)
    plain.finalize()
    n_changed = 0
    for req, jreq, plain_req in zip(flank_requests, jax_flank_requests,
                                    plain.requests):
        scalar = jax_score._scalar_flank_scores(jreq, 3, 2)
        np.testing.assert_array_equal(pending.pair_scores[id(req)], scalar)
        np.testing.assert_array_equal(jax_pending.pair_scores[id(jreq)], scalar)
        np.testing.assert_array_equal(
            port_score._scalar_flank_scores(req, 3, 2), scalar)
        n_changed += int((scalar != plain.pair_scores[id(plain_req)]).sum())
    assert n_changed > 0  # the flank correction did something
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_flank_chunks_under_the_byte_bound(flank_requests, region_requests,
                                           monkeypatch):
    """A label-block bound below one lane chunk cuts the flank pairs into
    many K2 chunks; flank and plain requests mixed in one dispatch give
    the matrices of separate dispatches, and no launch is counted on the
    CPU."""
    plain_reqs = [r for r in region_requests[len(flank_requests):]
                  if r is not None][:3]
    want = (port_score.dispatch_alignment_requests(flank_requests, CPU).finalize()
            + port_score.dispatch_alignment_requests(plain_reqs, CPU).finalize())
    L2 = flank_requests[0].sub_seq.shape[1]
    monkeypatch.setattr(port_score, "FLANK_BP_BYTES", 50 * (L2 + 8) * 8 * 4)
    before = dict(align_cuda.LAUNCHES)
    pending = port_score.dispatch_alignment_requests(
        flank_requests + plain_reqs, CPU)
    chunks = [c for _, group_chunks in pending.flank_groups for c in group_chunks]
    assert len(chunks) > 5
    assert max(sl.stop - sl.start for _, sl in chunks) == 50
    got = pending.finalize()
    assert align_cuda.LAUNCHES == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_device_inference_matches_jax_package(region):
    """The port's fused-inference bridge (bucketing, upload, gather) against
    the JAX package's on a real region's windows.  Tolerances are those of
    test_torch_likelihood.py (same f32 algorithm, other summation order)."""
    from platypus_tpu.parallel.batch import run_device_inference as jax_run
    from platypus_tpu_torch.parallel.batch import run_device_inference

    want = jax_run(*region[JAX_PKG], 1)
    got = run_device_inference(*region[PORT_PKG], 1, CPU)
    assert got.keys() == want.keys() and len(got) > 5
    for w_idx, w in want.items():
        g = got[w_idx]
        np.testing.assert_allclose(g.em, w.em, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.frequencies, w.frequencies, rtol=1e-4, atol=1e-5)
        assert g.ratios.keys() == w.ratios.keys()
        for v, r in w.ratios.items():
            assert abs(g.ratios[v] - r) <= 1e-3
        assert abs(g.em_margin - w.em_margin) <= 1e-5
