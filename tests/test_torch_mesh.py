"""The torch port's mesh path (platypus_tpu_torch/parallel/mesh.py) and its
driver entry points (platypus_tpu_torch/graft_entry.py) on the CPU,
against the JAX package's mesh on its 8 virtual CPU devices.

Tolerances: pair scores and the host-rebuilt log-likelihoods are integer
or float64 functions of the same DP and must be equal.  The inference is
f32 in both: em, frequencies and em_margin within rtol 1e-4 / atol 1e-5
and ratios within atol 1e-3, as tests/test_torch_likelihood.py states
(only the order of summation differs).  In the demo step the port adds
its lane shards' genotype log-likelihood sums in lane order where XLA
reduces across the lane axis in its own: the GL sums agree to a few f32
ulps, and after 20 EM iterations the frequencies differed by at most
2.4e-7 over four seeds of make_example_batch.  The test holds frequencies
within rtol 1e-4 / atol 1e-5 and ratios within atol 1e-3, as above.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch

from platypus_tpu.engine.caller import finish_window as jax_finish_window
from platypus_tpu.parallel import mesh as jax_mesh
from platypus_tpu_torch import cli as port_cli
from platypus_tpu_torch import graft_entry
from platypus_tpu_torch.config import PlatypusConfig
from platypus_tpu_torch.engine import region as port_region
from platypus_tpu_torch.engine import score as port_score
from platypus_tpu_torch.engine.caller import finish_window
from platypus_tpu_torch.ops import align_cuda
from platypus_tpu_torch.parallel import mesh as port_mesh
from platypus_tpu_torch.utils.backend import DeviceError
from torch_pool_util import (cli_args, data_lines, make_dataset,
                             reference_lines, run_port_cli, time_limit)
from torch_twin_util import JAX_PKG, PORT_PKG, prepare

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(120):
        yield


@pytest.fixture(scope="module")
def flank_region(tmp_path_factory):
    """test_device_inference.py:223's 6 kb dataset with three planted
    variants: (bam, ref path)."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    workdir = str(tmp_path_factory.mktemp("torch_mesh"))
    ref_path, ref_seq = make_reference(workdir, length=6000, seed=21)
    alt = SimHaplotype(ref_seq, [
        (1200, 1, b"A" if ref_seq[1200] != ord("A") else b"C"),
        (2500, 0, b"TG"),
        (3900, 2, b""),
    ])
    reads = simulate_reads([SimHaplotype(ref_seq, []), alt], 800, 5200,
                           read_len=80, coverage=24, seed=9)
    return write_synth_bam(workdir, reads, ref_len=6000), ref_path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_mesh_cli"))
    return workdir, make_dataset(workdir)


def _config_kw(flank_region, flank):
    bam, ref_path = flank_region
    return dict(bam_files=[bam], ref_file=ref_path, output="-",
                calculate_flank_score=flank, mesh_devices=8)


def _config(flank_region, flank):
    return PlatypusConfig(**_config_kw(flank_region, flank))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_factors_like_jax(n):
    mesh = port_mesh.make_mesh(devices=[CPU] * n)
    assert mesh.shape == dict(jax_mesh.make_mesh(n).shape)
    assert mesh.size == n
    assert [d for row in mesh.devices for d in row] == [CPU] * n


def test_mesh_names_a_missing_card(monkeypatch):
    """More devices than are visible raise, naming both counts; -1 and 0
    mean every local device of the run's device type."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh of 2 devices.*1 are visible"):
        port_mesh.make_mesh(2)
    with pytest.raises(ValueError, match="mesh of 4 devices.*1 are visible"):
        port_mesh.get_engine_mesh(4, "cuda")
    assert port_mesh.get_engine_mesh(-1, "cuda").devices == [
        [torch.device("cuda", 0)]]
    assert port_mesh.get_engine_mesh(0, "cpu").size == 1
    assert port_mesh.get_engine_mesh(8, "cpu").shape == {"win": 4, "lane": 2}
    with pytest.raises(ValueError, match="mesh of 3 devices.*2 are visible"):
        port_mesh.make_mesh(3, devices=["cpu", "cpu"])


def test_calling_step_matches_jax():
    """build_calling_step on make_example_batch against the JAX step on
    make_mesh(8): the port's 8-shard CPU mesh is 4 x 2, as JAX's."""
    mesh = port_mesh.make_mesh(devices=[CPU] * 8)
    batch = port_mesh.make_example_batch(W=8, Rmax=16)
    for a, b in zip(batch, jax_mesh.make_example_batch(W=8, Rmax=16)):
        assert np.array_equal(a, b)
    jmesh = jax_mesh.make_mesh(8)
    with jmesh:
        want = [np.asarray(x) for x in
                jax_mesh.build_calling_step(jmesh, em_iters=20)(*batch)]
    freqs, ratios, scores = port_mesh.build_calling_step(mesh, em_iters=20)(*batch)
    assert np.array_equal(scores, want[2])
    np.testing.assert_allclose(freqs, want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ratios, want[1], rtol=0, atol=1e-3)
    one = port_mesh.build_calling_step(port_mesh.make_mesh(devices=[CPU]),
                                       em_iters=20)(*batch)
    assert np.array_equal(one[2], scores)


def test_dryrun_multichip(monkeypatch):
    """The dry run on an 8-shard CPU mesh builds its dataset with the
    port's own writers: tests/synth.py cannot be imported meanwhile."""
    monkeypatch.setitem(sys.modules, "synth", None)
    counts = graft_entry.dryrun_multichip(8, CPU)
    for mode in ("default", "flank"):
        assert counts[mode]["windows"] >= 3 and counts[mode]["calls"] >= 3


@pytest.mark.parametrize("call", [lambda: graft_entry.entry(),
                                  lambda: graft_entry.dryrun_multichip(1)],
                         ids=["entry", "dryrun_multichip"])
def test_graft_entry_points_default_to_the_card(monkeypatch, call):
    """Without a device argument both entry points ask for the card, and
    raise without one rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_graft_entry_matches_reference_entry():
    """entry() against __graft_entry__.entry(): scores bitwise, logliks
    within 1e-6 (the same f32 formula on the same integer scores)."""
    import __graft_entry__
    from platypus_tpu.ops.align_jax import band_align_padded

    forward, args = __graft_entry__.entry()
    want_ll = np.asarray(forward(*args))
    want_sc = np.asarray(band_align_padded(*args[:5]))
    p_forward, p_args = graft_entry.entry(CPU)
    for a, b in zip(p_args, args):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got_sc = port_mesh.band_align_padded(*p_args[:5]).numpy()
    assert np.array_equal(got_sc, want_sc)
    np.testing.assert_allclose(p_forward(*p_args).numpy(), want_ll,
                               rtol=0, atol=1e-6)


def _prepared(pkg, flank_region, flank):
    """Package `pkg`'s own preparation of the 6 kb region (the port's on
    the CPU; no alignment is queued with mesh_devices set)."""
    prep = prepare(pkg, ("chr20", 0, 6000), CPU,
                   **_config_kw(flank_region, flank))
    assert prep.state is not None and prep.state.pending is None
    assert prep.state.live
    return prep


@pytest.mark.parametrize("flank", [0, 1], ids=["default", "flank"])
def test_mesh_call_region_matches_jax(flank_region, flank):
    """Twin of test_device_inference.py:223: the port's mesh_call_region
    on an 8-shard CPU mesh against JAX's on make_mesh(8), each on the
    windows its own package prepared (flank windows scored through the
    port's K2 path)."""
    jax_prep = _prepared(JAX_PKG, flank_region, flank)
    prep = _prepared(PORT_PKG, flank_region, flank)
    state, n_samples = prep.state, prep.n_samples
    assert [w for w, _ in state.live] == [w for w, _ in jax_prep.state.live]
    if flank:
        assert any(p.request is not None and p.request.calculate_flank_score
                   for _, p in state.live)
    want_ll, want_inf, want_left = jax_mesh.mesh_call_region(
        jax_prep.state.live, n_samples, jax_mesh.make_mesh(8))
    with mock.patch.object(port_score, "_flank_scores",
                           wraps=port_score._flank_scores) as flank_calls:
        got_ll, got_inf, got_left = port_mesh.mesh_call_region(
            state.live, n_samples, port_mesh.get_engine_mesh(8, CPU))
    assert (flank_calls.call_count > 0) == bool(flank)
    assert all(p.request is None or p.request.n_pairs() == 0
               for _, p in got_left)
    assert [w for w, _ in got_left] == [w for w, _ in want_left]
    assert set(got_ll) == set(want_ll) and got_ll
    n_calls = 0
    jax_windows = dict(jax_prep.state.live)
    for w_idx, window in state.live:
        if w_idx not in want_inf:
            continue
        assert np.array_equal(got_ll[w_idx], want_ll[w_idx])
        g, w = got_inf[w_idx], want_inf[w_idx]
        np.testing.assert_allclose(g.em, w.em, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.frequencies, w.frequencies,
                                   rtol=1e-4, atol=1e-5)
        assert list(g.ratios) == list(w.ratios)
        np.testing.assert_allclose(list(g.ratios.values()),
                                   list(w.ratios.values()), rtol=0, atol=1e-3)
        assert abs(g.em_margin - w.em_margin) <= 1e-5
        port_call = finish_window(window, got_ll[w_idx], prep.ref,
                                  prep.config, inference=g)
        jax_call = jax_finish_window(jax_windows[w_idx], want_ll[w_idx],
                                     jax_prep.ref, jax_prep.config,
                                     inference=w)
        assert (port_call is None) == (jax_call is None)
        if port_call is not None:
            assert port_call.genotype_calls == jax_call.genotype_calls
            assert port_call.variant_posteriors.keys() == \
                jax_call.variant_posteriors.keys()
            n_calls += len(port_call.variant_posteriors)
    assert n_calls >= 3
    prep.close()
    jax_prep.close()


@pytest.mark.parametrize("flank", [0, 1], ids=["default", "flank"])
def test_pair_scores_do_not_depend_on_the_mesh(flank_region, flank):
    """The same region on meshes of 1, 2, 3 and 8 shards: pair scores
    bitwise equal, identical calls, each equal to the host path's."""
    meshes = [port_mesh.make_mesh(devices=[CPU] * n) for n in (1, 2, 3, 8)]
    counts = graft_entry.check_mesh_region(
        _config(flank_region, flank), ("chr20", 0, 6000), CPU, meshes)
    assert counts["windows"] >= 3 and counts["calls"] >= 3


def test_deferred_fetch_reads_each_device_once(flank_region, monkeypatch):
    """defer=True queues the work and fetches nothing; fetch() then reads
    each distinct device of the mesh once (one, on the CPU)."""
    prep = _prepared(PORT_PKG, flank_region, 0)
    fetches = mock.Mock(wraps=port_mesh.fetch)
    monkeypatch.setattr(port_mesh, "fetch", fetches)
    fetch_fn, leftover = port_mesh.mesh_call_region(
        prep.state.live, prep.n_samples, port_mesh.get_engine_mesh(8, CPU),
        defer=True)
    assert fetches.call_count == 0 and not leftover
    ll_by, inf_by = fetch_fn()
    assert fetches.call_count == 1 and set(ll_by) == set(inf_by)
    prep.close()


def test_scatter_min_with_duplicates_is_order_free():
    """The region step's scatter_reduce(amin) into an INT32_MAX base:
    duplicate targets and pad pairs give the same tensor in any order,
    equal to np.minimum.at."""
    rng = np.random.default_rng(5)
    target = rng.integers(0, 40, size=600)
    scores = rng.integers(0, 5000, size=600).astype(np.int32)
    scores[::7] = np.iinfo(np.int32).max          # pad pairs, index 0
    target[::7] = 0
    want = np.full(40, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(want, target, scores)
    for seed in range(3):
        perm = np.random.default_rng(seed).permutation(len(target))
        base = torch.full((40,), np.iinfo(np.int32).max, dtype=torch.int32)
        got = base.scatter_reduce(0, torch.from_numpy(target[perm]),
                                  torch.from_numpy(scores[perm]), "amin",
                                  include_self=True)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("flank", [0, 1], ids=["default", "flank"])
def test_port_cli_mesh_matches_jax_default_run(tmp_path, dataset, flank):
    """The port's CLI with --meshDevices=8 on the CPU, in a fresh
    interpreter with jax blocked, writes the data lines of the CPU-pinned
    JAX package's default run (twin of test_s55_real_reads.py:108 on
    synthetic reads), and its --verbosity=3 summary logs the mesh spans."""
    workdir, ref_path = dataset
    extra = ["--calculateFlankScore=1"] if flank else []
    want = reference_lines(workdir, ref_path, extra)
    out = str(tmp_path / "mesh.vcf")
    proc, imports = run_port_cli(
        tmp_path, cli_args(workdir, ref_path, out,
                           ["--meshDevices=8", "--verbosity=3", *extra]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert want and data_lines(out) == want
    with open(f"{out}.log") as fh:
        summaries = [line for line in fh if " cumulative: " in line]
    assert summaries
    for span in ("mesh_pack_launch", "mesh_fetch", "mesh_unpack"):
        assert f" {span}=" in summaries[-1], summaries[-1]
    assert not [line for line in imports if line.startswith("jax")]


@pytest.mark.parametrize("stage", ["step", "fetch", "leftover"])
def test_mesh_stage_failure_raises(tmp_path, dataset, monkeypatch, stage):
    """A failing mesh stage leaves as DeviceError: no region is skipped,
    no VCF line is written, and the dispatch path never runs."""
    workdir, ref_path = dataset

    def fail(*args, **kwargs):
        raise RuntimeError("mesh stage failed: CUDA error 700")

    if stage == "step":
        monkeypatch.setattr(port_mesh, "mesh_call_region", fail)
    elif stage == "fetch":
        monkeypatch.setattr(port_mesh, "window_loglik_from_pair_scores", fail)
    else:
        # every window is left over, and aligning them fails
        monkeypatch.setattr(port_mesh, "mesh_call_region",
                            lambda live, *a, **k: (lambda: ({}, {}), live))
        monkeypatch.setattr(align_cuda, "band_align_pairs", fail)
    monkeypatch.setattr(port_region, "dispatch_alignment_requests",
                        mock.Mock(side_effect=AssertionError("dispatch path")))
    out = str(tmp_path / "fail.vcf")
    with pytest.raises(DeviceError, match="CUDA error 700"):
        port_cli.main(cli_args(workdir, ref_path, out, ["--meshDevices=8"]),
                      device="cpu")
    assert data_lines(out) == []
    with open(f"{out}.log") as fh:
        assert "will be skipped" not in fh.read()
