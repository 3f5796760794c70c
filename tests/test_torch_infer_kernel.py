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
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import INFER_SHAPES, compare_inference, random_windows
from platypus_tpu_torch.ops import align_cuda, likelihood_cuda, likelihood_torch
from platypus_tpu_torch.ops.likelihood import genotype_index_pairs

# (label, seed, (W, Hb, Rb, I, Vb), expected memory path)
CASES = [
    ("shared-Hb12-I1", 1, (6, 12, 96, 1, 6), "shared"),
    ("shared-Hb24-I4-padded", 2, (5, 24, 64, 4, 5), "shared"),
    ("global-Hb256-I1", 3, (2, 256, 64, 1, 3), "global"),
    ("global-Hb64-I30", 4, (6, 64, 256, 30, 4), "global"),
]


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
    assert likelihood_cuda.em_path(Hb, I) == path
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
    paths = {likelihood_cuda.em_path(Hb, I) for _W, Hb, _R, I, _V in INFER_SHAPES}
    assert paths == {"shared", "global"}


def test_em_path_splits_at_227_kb(monkeypatch):
    """Shared memory exactly while the tables and the kernel's reduction
    slots fit in 232448 bytes, global memory above."""
    limit = likelihood_cuda.SHARED_LIMIT
    assert limit == 227 * 1024
    for I in (1, 2, 30):
        H = max(h for h in range(1, 400)
                if likelihood_cuda.em_table_bytes(h, I) + 32 <= limit)
        assert likelihood_cuda.em_path(H, I) == "shared"
        assert likelihood_cuda.em_path(H + 1, I) == "global"
    assert likelihood_cuda.em_table_bytes(256, 1) == 4 * (2 * 32896 + 32896
                                                          + 2 * 256 + 1)
    assert likelihood_cuda.em_path(256, 1) == "global"
    assert likelihood_cuda.em_path(64, 30) == "global"
    assert likelihood_cuda.em_path(128, 1) == "shared"
    # A table that lands on the limit exactly takes shared memory.
    for size, path in ((limit - 32, "shared"), (limit - 31, "global")):
        monkeypatch.setattr(likelihood_cuda, "em_table_bytes",
                            lambda H, I, size=size: size)
        assert likelihood_cuda.em_path(1, 1) == path


def _hap_genotypes(n_haps):
    """The M-step's table as csrc/infer_window.cu walks it: row h holds
    pair_index(min(k, h), max(k, h)) for k = 0..H-1, with
    pair_index(i, j) = i*H - i*(i-1)/2 + j - i, and marks k == h."""
    k = torch.arange(n_haps)
    lo = torch.minimum(k[None, :], k[:, None])
    hi = torch.maximum(k[None, :], k[:, None])
    index = lo * n_haps - lo * (lo - 1) // 2 + (hi - lo)
    return index, k[None, :] == k[:, None]


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
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        _Fake(real_empty(*a, **k), torch.device(device)))
    monkeypatch.setattr(align_cuda, "load", lambda lib: SimpleNamespace(
        **dict.fromkeys(align_cuda.KERNELS[lib].entries, entry)))
    return SimpleNamespace(current=current, calls=calls)


def test_launch_runs_inside_the_inputs_device(fake_card):
    """The ctypes launch happens with the inputs' device current, the
    previous device is current again afterwards, and the launch counts."""
    dev = torch.device("cuda", 1)
    before = dict(align_cuda.LAUNCHES)
    likelihood_cuda.infer_window_batch(*_fake_inputs((3, 6, 64, 2, 3), dev))
    assert [d for d, _ in fake_card.calls] == [dev]
    assert fake_card.current == [torch.device("cuda", 0)]
    before["infer_window"] += 1
    assert align_cuda.LAUNCHES == before


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
def test_kernel_launches_give_identical_bits(cuda_device):
    for seed, shape in ((11, (8, 12, 96, 1, 6)), (12, (2, 64, 64, 30, 3))):
        args = _on(cuda_device, random_windows(seed, *shape))
        first, iters = likelihood_cuda.launch(*args)
        second, iters2 = likelihood_cuda.launch(*args)
        torch.cuda.synchronize()
        assert torch.equal(iters, iters2)
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_kernel_counts_each_launch(cuda_device):
    args = _on(cuda_device, random_windows(13, 4, 6, 64, 2, 3))
    before = dict(align_cuda.LAUNCHES)
    likelihood_cuda.infer_window_batch(*args)
    likelihood_cuda.infer_window_batch(*args)
    before["infer_window"] += 2
    assert align_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_poisons_a_batch_whose_pairs_are_not_lexicographic(cuda_device):
    args = _on(cuda_device, random_windows(14, 3, 6, 64, 2, 3))
    args[3], args[4] = args[4].flip(0).contiguous(), args[3].flip(0).contiguous()
    for out in likelihood_cuda.infer_window_batch(*args):
        assert torch.isnan(out).all()
