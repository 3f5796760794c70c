"""The fused window inference's card route (platypus_tpu_torch/ops/
likelihood_cuda.py, csrc/infer_window.cu): its wrapper on the CPU against
platypus_tpu.ops.likelihood_jax.infer_window_batch on the shapes where the
kernel's code paths split, its memory-path choice, the M-step's per-hap
table, its device routing and its failure modes; and, on a card, the
kernel against its plain torch version.

Tolerances are those of tests/test_torch_likelihood.py: rtol 1e-4 / atol
1e-5, ratios atol 1e-3, em_margin atol 1e-5 (the same f32 algorithm in
another summation order), with em, freq and ratios skipped for windows
whose EM margin is under engine/caller._EM_MARGIN_EPS in either version
(chip_smoke.compare_inference).  The JAX package is imported inside the
tests that use it, so that on a card host without jax

    python -m pytest --noconftest tests/test_torch_infer_kernel.py -m cuda

collects this file and runs the card tests.
"""

import contextlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (GL_FLOOR, INFER_SHAPES, check_wide_gl_rel,
                        compare_inference, random_windows)
from platypus_tpu_torch.ops import align_cuda, likelihood_cuda, likelihood_torch
from platypus_tpu_torch.ops.likelihood import genotype_index_pairs

# (label, seed, (W, Hb, Rb, I, Vb), expected route)
CASES = [
    ("shared-Hb12-I1", 1, (6, 12, 96, 1, 6), "shared"),
    ("shared-Hb24-I4-padded", 2, (5, 24, 64, 4, 5), "shared"),
    ("global-Hb256-I1", 3, (2, 256, 64, 1, 3), "global"),
    ("global-Hb64-I30", 4, (6, 64, 256, 30, 4), "global"),
    ("warp-Hb4-I1", 21, (9, 4, 64, 1, 3), "warp"),
    ("warp-Hb3-I25", 22, (7, 3, 192, 25, 3), "warp"),
    ("warp-Hb4-I16", 23, (5, 4, 96, 16, 4), "warp"),
    ("shared-split-Hb64-I1", 24, (3, 64, 64, 1, 3), "shared"),
    ("global-Hb160-I2", 25, (2, 160, 64, 2, 3), "global"),
]
# Every (case, route) the kernel can run: the route em_path picks and each
# other route whose tables fit.
ROUTED = [(c, r) for c in CASES for r in likelihood_cuda.ROUTES
          if likelihood_cuda.route_fits(r, c[2][1], c[2][3])]


def _jax_outputs(arrays, em_iters=100):
    from platypus_tpu.ops.likelihood_jax import infer_window_batch

    return [np.asarray(a) for a in infer_window_batch(*arrays,
                                                      em_iters=em_iters)]


def _assert_matches(got, want):
    """Every output within tolerance; guard-band windows (whose em, freq
    and ratios are not compared) are printed, and at least one window
    besides the padding one is compared in full."""
    errs, guard, bad = compare_inference(got, want)
    assert not bad, (bad, errs)
    print(f"guard-band windows: {guard}; max abs error {errs}")
    assert guard <= len(got[6]) - 2, guard


@pytest.mark.parametrize("label,seed,shape,path", CASES,
                         ids=[c[0] for c in CASES])
def test_wrapper_on_cpu_matches_jax(label, seed, shape, path):
    """The wrapper's CPU route on a batch of each code path: padded
    windows (the last is all padding), padded haps, reads and variant
    rows, individuals without reads (I > 2)."""
    arrays = random_windows(seed, *shape)
    W, Hb, Rb, I, Vb = shape
    assert likelihood_cuda.em_path(Hb, I, Rb) == path
    assert not arrays[2][-1].any() and not arrays[6][-1].any()
    got = [t.numpy() for t in likelihood_cuda.infer_window_batch(
        *(torch.from_numpy(a) for a in arrays))]
    _assert_matches(got, _jax_outputs(arrays))


def test_wrapper_on_cpu_matches_jax_with_few_iterations():
    """em_iters=3 cuts windows that have not converged, as the JAX loop's
    bound does."""
    arrays = random_windows(5, 4, 24, 64, 4, 3)
    got = [t.numpy() for t in likelihood_cuda.infer_window_batch(
        *(torch.from_numpy(a) for a in arrays), em_iters=3)]
    _assert_matches(got, _jax_outputs(arrays, em_iters=3))


def test_smoke_shapes_cover_both_paths():
    """The smoke's synthetic batches reach every route (em_path's choice)."""
    paths = {likelihood_cuda.em_path(Hb, I, R) for _W, Hb, R, I, _V in INFER_SHAPES}
    assert paths == {"warp", "shared", "global"}


def test_em_path_splits_at_227_kb(monkeypatch):
    """Past the warp route, shared memory exactly while the tables and the
    EM kernel's reduction slots fit in 232448 bytes, global memory above."""
    limit = likelihood_cuda.SHARED_LIMIT
    slots = likelihood_cuda._EM_STATIC_BYTES
    assert limit == 227 * 1024 and slots == 3 * 8 * 4
    for I in (1, 2, 30):
        H = max(h for h in range(1, 400)
                if likelihood_cuda.em_table_bytes(h, I) + slots <= limit)
        assert likelihood_cuda.em_path(H, I, 64) == "shared"
        assert likelihood_cuda.em_path(H + 1, I, 64) == "global"
    assert likelihood_cuda.em_table_bytes(256, 1) == 4 * (2 * 32896 + 32896
                                                          + 2 * 256 + 1)
    assert likelihood_cuda.em_path(256, 1, 64) == "global"
    assert likelihood_cuda.em_path(64, 30, 256) == "global"
    assert likelihood_cuda.em_path(128, 1, 64) == "shared"
    # A table that lands on the limit exactly takes shared memory.
    wide = max(likelihood_cuda.WARP_ROUTE_LIMIT) + 1
    for size, path in ((limit - slots, "shared"), (limit - slots + 1, "global")):
        monkeypatch.setattr(likelihood_cuda, "em_table_bytes",
                            lambda H, I, size=size: size)
        assert likelihood_cuda.em_path(wide, 1, 64) == path


@pytest.mark.parametrize("H,I,R,route", [
    (2, 1, 64, "warp"), (4, 1, 64, "warp"), (3, 16, 128, "warp"),
    (4, 25, 192, "warp"), (4, 30, 192, "warp"), (4, 32, 256, "shared"),
    (5, 1, 64, "shared"), (6, 2, 64, "shared"), (5, 3, 64, "shared"),
    (6, 16, 128, "shared"), (2, 33, 64, "shared"), (8, 25, 192, "shared"),
    (64, 1, 64, "shared"), (24, 4, 64, "shared"), (256, 1, 64, "global"),
    (64, 30, 256, "global"), (160, 2, 64, "global"),
    (2, 30, 1536, "warp"), (2, 30, 2048, "shared"), (3, 30, 256, "warp"),
    (3, 30, 384, "shared"), (4, 16, 768, "shared")])
def test_route_is_chosen_from_haps_and_individuals(H, I, R, route):
    """em_path decides from (Hmax, I, Rmax): the warp route for Hmax 2-4
    up to 32 individuals (one lane each) while its passes over the reads x
    Rmax stay within WARP_ROUTE_LIMIT[Hmax], then the CTA routes; the
    slice's batches (Hb 2 or 4, I = 1, Rb = 64) and the 16-sample cohort's
    small-Hb batches take the warp route.  route_fits says which routes a
    batch may be forced to, whatever its reads."""
    assert likelihood_cuda.em_path(H, I, R) == route
    fits = [r for r in likelihood_cuda.ROUTES
            if likelihood_cuda.route_fits(r, H, I)]
    assert route in fits and "global" in fits
    assert ("warp" in fits) == (H in likelihood_cuda.WARP_ROUTE_LIMIT
                                and I <= 32)


def test_warp_route_limit_stays_inside_its_kernel():
    """Every Hmax the warp route takes has a kernel instance, whose
    individuals a pass over the reads (kC) WARP_PASS_IND states; the read
    limit applies to passes x Rmax; past 32 individuals or the table's
    Hmax a CTA route runs."""
    limit = likelihood_cuda.WARP_ROUTE_LIMIT
    assert sorted(limit) == sorted(_warp_kernel_instances())
    with open(align_cuda.source("infer_window")) as fh:
        small, wide, narrow = map(int, re.search(
            r"constexpr int kC = kG <= (\d+) \? (\d+) : (\d+);",
            fh.read()).groups())
    for H, top in limit.items():
        kC = wide if H * (H + 1) // 2 <= small else narrow
        assert likelihood_cuda.WARP_PASS_IND[H] == kC
        assert likelihood_cuda.em_path(H, 1, top) == "warp"
        assert likelihood_cuda.em_path(H, 1, top + 1) != "warp"
        assert likelihood_cuda.em_path(H, kC, top) == "warp"
        assert likelihood_cuda.em_path(H, kC + 1, top) != "warp"
        assert likelihood_cuda.em_path(H, 33, 1) != "warp"
    for I in (1, 2, 16):
        assert likelihood_cuda.em_path(max(limit) + 1, I, 8) != "warp"


def _warp_kernel_instances():
    """The Hmax of each infer_window_warp_kernel instance the C entry
    launches."""
    with open(align_cuda.source("infer_window")) as fh:
        text = fh.read()
    return [int(h) for h in re.findall(
        r"case (\d+): infer_window_warp_kernel<(?:\d+)>", text)]


def test_warp_route_serves_every_small_bucket():
    """The warp route has a kernel for each Hmax of at most 4 that the
    batches' buckets (parallel/batch.py geom_bucket) give, and no other."""
    from platypus_tpu_torch.parallel.batch import geom_bucket

    buckets = sorted({geom_bucket(n) for n in range(1, 5)})
    assert buckets == sorted(_warp_kernel_instances()) == [2, 3, 4]


def _hap_genotypes(n_haps):
    """The M-step's table as csrc/infer_window.cu walks it: row h holds
    pair_index(min(k, h), max(k, h)) for k = 0..H-1, with
    pair_index(i, j) = i*H - i*(i-1)/2 + j - i, and marks k == h."""
    k = torch.arange(n_haps)
    lo = torch.minimum(k[None, :], k[:, None])
    hi = torch.maximum(k[None, :], k[:, None])
    index = lo * n_haps - lo * (lo - 1) // 2 + (hi - lo)
    return index, k[None, :] == k[:, None]


def _deep_batch():
    """A batch of 4 windows, Hmax 4, 3 individuals with 64 reads each: in
    window 0 hap 3 is far from every read (its genotypes' gl_rel floored),
    window 1 has 4 reads of small log-likelihood, all of individual 0
    (where float32's summation bound is under gl_rel's atol), windows 2-3
    have |gl| in the hundreds (the bound far past atol).
    Returns (numpy inputs, the same batch with its reads in another order:
    another summation order of every sum)."""
    rng = np.random.default_rng(17)
    W, H, I, per_ind = 4, 4, 3, 64
    R = I * per_ind
    ll = np.maximum(-np.abs(rng.normal(4.0, 4.0, (W, H, R))),
                    -300.0).astype(np.float32)
    ll[0, 3] = -30.0
    ll[1] *= np.float32(0.1)
    ll[1, :, 4:] = 0.0
    oh = np.zeros((W, I, R), np.float32)
    oh[:, np.repeat(np.arange(I), per_ind), np.arange(R)] = 1.0
    oh[1, :, 4:] = 0.0
    has_reads = np.ones((W, I), bool)
    has_reads[1, 1:] = False
    vm = np.zeros((W, 3, H), bool)
    vm[:, :, 1:] = rng.random((W, 3, H - 1)) < 0.5
    h1, h2 = genotype_index_pairs(H)
    arrays = [ll, oh, np.ones((W, H), bool), h1.astype(np.int32),
              h2.astype(np.int32), vm, has_reads]
    perm = rng.permutation(R)
    permuted = list(arrays)
    permuted[0] = np.ascontiguousarray(ll[:, :, perm])
    permuted[1] = np.ascontiguousarray(oh[:, :, perm])
    return arrays, permuted


def _gl_rel(arrays):
    return likelihood_torch.infer_window_batch(
        *(torch.from_numpy(a) for a in arrays))[5].numpy()


@pytest.mark.parametrize("fault", [None, "floor dropped", "-inf", "nan",
                                   "narrow entry off", "wide entry off"])
def test_wide_gl_rel_check_passes_only_f32_rounding(fault):
    """chip_smoke.check_wide_gl_rel, the smoke's check of gl_rel where it
    misses atol 1e-5 against the plain version: another summation order
    passes, while a dropped floor, a non-finite value where the plain
    version is finite, an entry off where f32 can meet atol, or an entry
    off by far more than the plain version's own distance from float64,
    each fail."""
    arrays, permuted = _deep_batch()
    want, got = _gl_rel(arrays), _gl_rel(permuted)
    args = [torch.from_numpy(a) for a in arrays]
    assert (want[0] == np.float32(GL_FLOOR)).any()
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() > 1e-5  # past atol somewhere
    got = got.copy()
    if fault == "floor dropped":
        floored = want == np.float32(GL_FLOOR)
        got[floored] = GL_FLOOR - 500.0
    elif fault in ("-inf", "nan"):
        got[2, 1, 4] = float(fault)
    elif fault == "narrow entry off":
        got[1, 0, 3] += 1e-2
    elif fault == "wide entry off":
        got[3, 2, 5] += 20 * max(np.abs(got - want).max(), 1e-5)
    passed, note = check_wide_gl_rel(args, got, want)
    assert passed == (fault is None), note


@pytest.mark.parametrize("H", [1, 2, 5, 12, 33])
def test_hap_genotypes_table_equals_logA_scatter(H):
    """Row h of the kernel's M-step table holds the genotypes that contain
    hap h, in increasing order, with the homozygous one marked; the per-hap
    logsumexp over it (+ ln 2 for that one) equals the plain version's
    logsumexp over log_resp + logA."""
    h1, h2 = (torch.from_numpy(a.copy()) for a in genotype_index_pairs(H))
    index, homozygous = _hap_genotypes(H)
    for h in range(H):
        holds = torch.nonzero((h1 == h) | (h2 == h))[:, 0]
        assert index[h].tolist() == holds.tolist()
        assert homozygous[h].tolist() == [(h1[g] == h2[g]).item()
                                          for g in holds]
    rng = np.random.default_rng(H)
    log_resp = torch.from_numpy(rng.normal(-3, 2, len(h1)).astype(np.float32))
    log_resp[rng.random(len(h1)) < 0.2] = float("-inf")
    counts = (torch.nn.functional.one_hot(h1, H)
              + torch.nn.functional.one_hot(h2, H)).float()
    logA = torch.where(counts > 0, torch.log(counts.clamp_min(1e-30)),
                       float("-inf"))
    want = likelihood_torch._lse(log_resp[:, None] + logA, 0)
    terms = log_resp[index] + torch.where(homozygous, likelihood_torch.LOG2,
                                          0.0)
    got = likelihood_torch._lse(terms, 1)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_other_devices():
    t = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        likelihood_cuda.infer_window_batch(t, t, t[:, 0], t[0, 0], t[0, 0], t,
                                           t[:, 0])


class _Fake:
    """A CPU tensor that reports a CUDA device: as much of a tensor as the
    wrapper's checks, allocations and pointers use."""

    def __init__(self, t, device, contiguous=True):
        self._t, self.device, self.dtype, self.shape = t, device, t.dtype, t.shape
        self._contiguous = contiguous

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._t.data_ptr()


def _fake_inputs(shape, device, seed=7):
    return [_Fake(torch.from_numpy(a), device)
            for a in random_windows(seed, *shape)]


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda.device / current_stream and torch.empty standing in for a
    card, and a kernel library whose entry records each launch (the
    device current at the call and its arguments)."""
    current = [torch.device("cuda", 0)]
    calls = []

    @contextlib.contextmanager
    def fake_device(d):
        previous = current[0]
        current[0] = torch.device(d)
        try:
            yield
        finally:
            current[0] = previous

    def entry(*args):
        calls.append((current[0], args))
        return 0

    real_empty = torch.empty
    allocs = []

    def empty(*a, device=None, **k):
        allocs.append(_Fake(real_empty(*a, **k), torch.device(device)))
        return allocs[-1]

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(align_cuda, "load", lambda lib: SimpleNamespace(
        **dict.fromkeys(align_cuda.KERNELS[lib].entries, entry)))
    return SimpleNamespace(current=current, calls=calls, allocs=allocs)


def test_launch_runs_inside_the_inputs_device(fake_card):
    """The ctypes launch happens with the inputs' device current, the
    previous device is current again afterwards, and the launch counts."""
    dev = torch.device("cuda", 1)
    before = align_cuda.launches()
    likelihood_cuda.infer_window_batch(*_fake_inputs((3, 6, 64, 2, 3), dev))
    assert [d for d, _ in fake_card.calls] == [dev]
    assert fake_card.current == [torch.device("cuda", 0)]
    before["infer_window"] += 1
    assert align_cuda.launches() == before


@pytest.mark.parametrize("shape,path", [((3, 12, 64, 1, 3), "shared"),
                                        ((2, 256, 64, 1, 3), "global"),
                                        ((2, 64, 64, 30, 3), "global")])
def test_launch_passes_a_workspace_only_on_the_global_path(fake_card, shape,
                                                            path):
    """The entry's workspace argument is null on the shared-memory path and
    a [W, table] float workspace on the global one; the sizes and tol
    follow the batch."""
    W, Hb, Rb, I, Vb = shape
    likelihood_cuda.infer_window_batch(*_fake_inputs(shape, torch.device("cuda")))
    (_dev, args), = fake_card.calls
    workspace = args[15]
    assert args[16:23] == (W, Hb, Rb, I, Vb, 100, min(1e-3, 1 / (4 * I)))
    assert (workspace is None) == (path == "shared")


@pytest.mark.parametrize("shape,route", [((3, 4, 64, 2, 3), "warp"),
                                         ((3, 64, 64, 1, 3), "shared"),
                                         ((2, 64, 64, 30, 3), "global")])
def test_outputs_and_workspace_allocations(fake_card, shape, route):
    """A launch allocates lik, em, gof, gl_rel [W, I, G], freq [W, H],
    ratios [W, V], margin [W] float32 and iters [W] int32, the outputs
    ending with iters, and on the global route the [W, table] float32
    workspace; the entry gets their pointers and the route as its index
    in ROUTES."""
    W, Hb, Rb, I, Vb = shape
    G = Hb * (Hb + 1) // 2
    outs, iters = likelihood_cuda.launch(
        *_fake_inputs(shape, torch.device("cuda")))
    (_dev, args), = fake_card.calls
    assert args[23] == likelihood_cuda.ROUTES.index(route)
    want = [(W, I, G)] * 2 + [(W, Hb), (W, I, G), (W, Vb), (W, I, G), (W,)]
    assert [tuple(t.shape) for t in outs[:7]] == want
    assert all(t.dtype == torch.float32 for t in outs[:7])
    assert tuple(iters.shape) == (W,) and iters.dtype == torch.int32
    assert len(outs) == 8 and outs[7] is iters
    assert args[7:15] == tuple(t.data_ptr() for t in outs)
    work = fake_card.allocs[8:]
    if route == "global":
        (work,) = work
        assert work.dtype == torch.float32
        assert work._t.numel() * 4 == W * likelihood_cuda.em_table_bytes(Hb, I)
        assert args[15] == work.data_ptr()
    else:
        assert work == [] and args[15] is None
    assert len(fake_card.allocs) == 8 + (route == "global")


def test_a_route_that_does_not_fit_raises(fake_card):
    """Forcing the warp or shared route onto a batch whose tables do not
    fit raises before any allocation or launch; no route gives way."""
    for route in ("warp", "shared", "bogus"):
        with pytest.raises(ValueError, match="cannot run"):
            likelihood_cuda.launch(
                *_fake_inputs((2, 256, 64, 1, 3), torch.device("cuda")),
                route=route)
    assert fake_card.calls == [] and fake_card.allocs == []


def test_wrapper_checks_its_inputs(fake_card):
    dev = torch.device("cuda")
    good = _fake_inputs((3, 6, 64, 2, 3), dev)
    bad_h1 = list(good)
    bad_h1[3] = _Fake(good[3]._t.long(), dev)
    with pytest.raises(ValueError, match="h1 must be torch.int32"):
        likelihood_cuda.infer_window_batch(*bad_h1)
    elsewhere = list(good)
    elsewhere[6] = _Fake(good[6]._t, torch.device("cuda", 3))
    with pytest.raises(ValueError, match="has_reads must be torch.bool on"):
        likelihood_cuda.infer_window_batch(*elsewhere)
    strided = list(good)
    strided[1] = _Fake(good[1]._t, dev, contiguous=False)
    with pytest.raises(ValueError, match="sample_onehot must be a contiguous"):
        likelihood_cuda.infer_window_batch(*strided)
    short = list(good)
    short[4] = _Fake(good[4]._t[:-1], dev)
    with pytest.raises(ValueError, match="h2 must be a contiguous"):
        likelihood_cuda.infer_window_batch(*short)
    assert fake_card.calls == []


def test_failed_build_raises_and_never_returns_the_plain_result(
        tmp_path, monkeypatch):
    """With nvcc failing, a call on CUDA tensors raises the build error;
    the plain version is not run in its place."""
    monkeypatch.setattr(align_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(align_cuda, "_libs", {})
    monkeypatch.setattr(align_cuda, "_nvcc", lambda: "false")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA call")

    monkeypatch.setattr(likelihood_cuda, "infer_window_batch_reference", plain)
    with pytest.raises(RuntimeError, match="nvcc failed building .*infer_window"):
        likelihood_cuda.infer_window_batch(
            *_fake_inputs((3, 6, 64, 2, 3), torch.device("cuda")))


def test_callers_route_through_the_wrapper(monkeypatch):
    """parallel/batch.launch_fused_inference (the main path, the pool's
    device worker, the service) and the mesh's region step call the
    wrapper, which is what sends a card tensor to the kernel."""
    from platypus_tpu_torch.parallel import batch, mesh

    assert mesh.infer_window_batch is likelihood_cuda.infer_window_batch
    seen = []

    def wrapper(*args, **kwargs):
        seen.append([a.dtype for a in args])
        return likelihood_torch.infer_window_batch(*args, **kwargs)

    monkeypatch.setattr(likelihood_cuda, "infer_window_batch", wrapper)
    ll, oh, hm, _h1, _h2, vm, hr = random_windows(8, 3, 6, 64, 2, 3)
    h1, h2, dev = batch.launch_fused_inference(ll, oh, hm, vm, hr, "cpu")
    assert len(seen) == 1 and seen[0][3] == seen[0][4] == torch.int32
    assert len(dev) == 7 and (h1 == genotype_index_pairs(6)[0]).all()


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip.  Decided inside the fixture, never at import or
    collection time, so every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("label,seed,shape,path", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version_on_card(cuda_device, label, seed, shape,
                                              path):
    args = _on(cuda_device, random_windows(seed, *shape))
    got = likelihood_cuda.infer_window_batch(*args)
    want = likelihood_torch.infer_window_batch(*args)
    torch.cuda.synchronize()
    _assert_matches([t.cpu().numpy() for t in got],
                    [t.cpu().numpy() for t in want])


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", ROUTED,
                         ids=[f"{c[0]}-on-{r}" for c, r in ROUTED])
def test_every_route_matches_plain_version_on_card(cuda_device, case, route):
    """Each case on every route that fits it, em_path's or not."""
    _label, seed, shape, _path = case
    args = _on(cuda_device, random_windows(seed, *shape))
    got, iters = likelihood_cuda.launch(*args, route=route)
    want = likelihood_torch.infer_window_batch(*args)
    torch.cuda.synchronize()
    _assert_matches([t.cpu().numpy() for t in got],
                    [t.cpu().numpy() for t in want])
    assert (iters.cpu().numpy() >= 1).all()


@pytest.mark.cuda
def test_kernel_launches_give_identical_bits(cuda_device):
    for seed, shape in ((11, (8, 12, 96, 1, 6)), (12, (2, 64, 64, 30, 3)),
                        (15, (9, 4, 64, 1, 3)), (16, (5, 4, 96, 16, 4))):
        args = _on(cuda_device, random_windows(seed, *shape))
        for route in likelihood_cuda.ROUTES:
            if not likelihood_cuda.route_fits(route, shape[1], shape[3]):
                continue
            first, iters = likelihood_cuda.launch(*args, route=route)
            second, iters2 = likelihood_cuda.launch(*args, route=route)
            torch.cuda.synchronize()
            assert torch.equal(iters, iters2)
            for a, b in zip(first, second):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_kernel_counts_each_launch(cuda_device):
    args = _on(cuda_device, random_windows(13, 4, 6, 64, 2, 3))
    before = align_cuda.launches()
    likelihood_cuda.infer_window_batch(*args)
    likelihood_cuda.infer_window_batch(*args)
    before["infer_window"] += 2
    assert align_cuda.launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("route", likelihood_cuda.ROUTES)
def test_kernel_poisons_a_batch_whose_pairs_are_not_lexicographic(cuda_device,
                                                                  route):
    args = _on(cuda_device, random_windows(14, 3, 4, 64, 2, 3))
    args[3], args[4] = args[4].flip(0).contiguous(), args[3].flip(0).contiguous()
    outs, iters = likelihood_cuda.launch(*args, route=route)
    for out in outs[:7]:
        assert torch.isnan(out).all()
    assert (iters == -1).all()


@pytest.mark.cuda
def test_gl_and_gof_keep_their_bits_on_every_route(cuda_device):
    """The warp route computes GL/GOF in its own launch in the GL kernel's
    order of summation: lik, gof and gl_rel equal the CTA routes' bits."""
    args = _on(cuda_device, random_windows(17, 6, 4, 96, 16, 4))
    outs = {r: likelihood_cuda.launch(*args, route=r)[0]
            for r in likelihood_cuda.ROUTES}
    torch.cuda.synchronize()
    for k in (0, 3, 5):  # lik, gof, gl_rel
        for r in ("shared", "global"):
            assert torch.equal(outs["warp"][k].view(torch.int32),
                               outs[r][k].view(torch.int32))
