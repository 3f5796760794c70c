"""K1 (platypus_tpu_torch/csrc/band_align.cu: its padded entry and its pair
entry, which gathers and pads its pairs from the deduplicated matrices) and
K2, its traceback mode (csrc/band_align_tb.cu, a pair entry with 16-bit
label words), on the card, against their plain torch versions.
These tests need a CUDA device and skip without one; this file imports no
jax, so on a machine with a card and without jax run it as

    python -m pytest --noconftest tests/test_torch_kernel.py -m cuda

One test runs on the CPU: it stands in a recording fake for the card and
the kernel library, and shows each wrapper launching with the inputs'
device made current.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (flank_golden_mismatches, flank_goldens,
                        golden_groups, pair_inputs, random_pairs, tie_pairs)
from platypus_tpu_torch.ops import align_cuda, align_torch


@pytest.fixture
def cuda_device():
    """The card, or a skip.  Decided inside the fixture, never at import or
    collection time, so every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_dp_on_card(cuda_device):
    """Bitwise on every golden and on B=2000 (not a multiple of the block)
    mixed-length pairs with 'N' bases."""
    cases = [(ge, npr, inputs) for ge, npr, inputs, _ in golden_groups()]
    cases.append((3, 2, random_pairs(3, 2000, 100)))
    for ge, npr, inputs in cases:
        padded = align_torch.pad_alignment_inputs(*inputs, device=cuda_device)
        got = align_cuda.band_align_padded(*padded, gapextend=ge, nucprior=npr)
        want = align_torch.band_align_padded_reference(*padded, gapextend=ge,
                                                       nucprior=npr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_counts_each_launch(cuda_device):
    padded = align_torch.pad_alignment_inputs(*random_pairs(4, 300, 64),
                                              device=cuda_device)
    before = align_cuda.launches()
    align_cuda.band_align_padded(*padded)
    align_cuda.band_align_padded(*padded)
    before["band_align"] += 2
    assert align_cuda.launches() == before


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    hap, go, read, qual, rlen = align_torch.pad_alignment_inputs(
        *random_pairs(5, 256, 32), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        align_cuda.band_align_padded(hap.long(), go, read, qual, rlen)
    with pytest.raises(ValueError, match="contiguous"):
        align_cuda.band_align_padded(hap[:, ::2], go[:, ::2], read[:, ::2],
                                     qual[:, ::2], rlen[::2])
    with pytest.raises(ValueError, match="int32 on"):
        align_cuda.band_align_padded(hap.cpu(), go, read, qual, rlen)


@pytest.mark.cuda
def test_pair_entry_matches_plain_version_on_card(cuda_device):
    """The pair entry bitwise on every golden (identity indices), on
    mixed-length pairs with 'N' bases at B = 1, 127 and 2047 and on
    overhanging segments."""
    cases = [(ge, npr, pair_inputs(inputs, cuda_device))
             for ge, npr, inputs, _ in golden_groups()]
    for seed, B in enumerate((1, 127, 2047)):
        cases.append((3, 2, pair_inputs(random_pairs(20 + seed, B, 100),
                                        cuda_device, width=128)))
    cases.append((3, 2, pair_inputs(random_pairs(23, 1000, 128), cuda_device,
                                    overhang_seed=23)))
    cases.append((3, 2, pair_inputs(random_pairs(23, 1000, 128), cuda_device,
                                    overhang_seed=23, width=160)))
    for ge, npr, args in cases:
        got = align_cuda.band_align_pairs(*args, gapextend=ge, nucprior=npr)
        want = align_torch.band_align_pairs_reference(*args, gapextend=ge,
                                                      nucprior=npr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_pair_entry_counts_each_launch(cuda_device):
    args = pair_inputs(random_pairs(24, 300, 64), cuda_device)
    before = align_cuda.launches()
    align_cuda.band_align_pairs(*args)
    align_cuda.band_align_pairs(*args)
    before["band_align"] += 2
    assert align_cuda.launches() == before


@pytest.mark.cuda
def test_pair_entry_wrapper_rejects_bad_inputs(cuda_device):
    hap, go, seq, qual, ph, pr, ps, rl = pair_inputs(random_pairs(25, 256, 32),
                                                     cuda_device)
    pairs = align_cuda.band_align_pairs
    with pytest.raises(ValueError, match="uint8"):
        pairs(hap.int(), go, seq, qual, ph, pr, ps, rl)
    with pytest.raises(ValueError, match="int32"):
        pairs(hap, go, seq, qual, ph.long(), pr, ps, rl)
    with pytest.raises(ValueError, match="contiguous"):
        pairs(hap, go, seq, qual, ph[::2], pr[::2], ps[::2], rl[::2])
    with pytest.raises(ValueError, match="contiguous"):
        pairs(hap, go[:, :-1], seq, qual, ph, pr, ps, rl)
    with pytest.raises(ValueError, match="int32 on"):
        pairs(hap, go, seq, qual, ph, pr, ps.cpu(), rl)


@pytest.mark.cuda
def test_tb_kernel_matches_plain_dp_on_card(cuda_device):
    """K2's pair entry: score, exit index and label block bitwise against
    its plain version on the flank goldens (identity indices; the host
    backtrace then recovers their alignments), on B=2000 mixed-length
    pairs with 'N' bases and overhanging segments, and on tied exit cells."""
    cases, golden_inputs = flank_goldens()
    golden = pair_inputs(golden_inputs, cuda_device)
    for args in (golden,
                 pair_inputs(random_pairs(6, 2000, 100), cuda_device,
                             overhang_seed=6, width=128),
                 pair_inputs(tie_pairs(6, 300, 100), cuda_device, width=128)):
        got = align_cuda.band_align_traceback_pairs(*args)
        want = align_torch.band_align_traceback_pairs_reference(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    got = align_cuda.band_align_traceback_pairs(*golden)
    assert flank_golden_mismatches(cases, *(t.cpu().numpy() for t in got)) == []


@pytest.mark.cuda
def test_tb_kernel_counts_each_launch(cuda_device):
    args = pair_inputs(random_pairs(7, 300, 64), cuda_device)
    before = align_cuda.launches()
    align_cuda.band_align_traceback_pairs(*args)
    align_cuda.band_align_traceback_pairs(*args)
    before["band_align_tb"] += 2
    assert align_cuda.launches() == before


@pytest.mark.cuda
def test_tb_kernel_wrapper_rejects_bad_inputs(cuda_device):
    hap, go, seq, qual, ph, pr, ps, rl = pair_inputs(random_pairs(8, 256, 32),
                                                     cuda_device)
    tb = align_cuda.band_align_traceback_pairs
    with pytest.raises(ValueError, match="uint8"):
        tb(hap, go, seq.int(), qual, ph, pr, ps, rl)
    with pytest.raises(ValueError, match="int32"):
        tb(hap, go, seq, qual, ph, pr.long(), ps, rl)
    with pytest.raises(ValueError, match="contiguous"):
        tb(hap, go, seq, qual, ph[::2], pr[::2], ps[::2], rl[::2])
    with pytest.raises(ValueError, match="int32 on"):
        tb(hap, go, seq, qual, ph, pr.cpu(), ps, rl)


class _CudaLike:
    """A CPU tensor that reports a CUDA device: as much of a tensor as the
    wrappers' checks, allocations and pointers use."""

    def __init__(self, t, device):
        self._t, self.device, self.dtype, self.shape = t, device, t.dtype, t.shape

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._t.data_ptr()


@pytest.mark.parametrize("name", ["band_align", "band_align_tb",
                                  "band_align_pairs"])
def test_launch_runs_inside_the_inputs_device(monkeypatch, name):
    """The ctypes launch happens with the inputs' device current (a
    launch from cuda:0's context into cuda:1's memory would fault), and
    the previous device is current again afterwards."""
    dev = torch.device("cuda", 1)
    current = [torch.device("cuda", 0)]
    launched_on = []

    @contextlib.contextmanager
    def fake_device(d):
        previous = current[0]
        current[0] = torch.device(d)
        try:
            yield
        finally:
            current[0] = previous

    def entry(*args):
        launched_on.append(current[0])
        return 0

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        _CudaLike(real_empty(*a, **k), torch.device(device)))
    monkeypatch.setattr(align_cuda, "load", lambda lib: SimpleNamespace(
        **dict.fromkeys(align_cuda.KERNELS[lib].entries, entry)))
    if name in ("band_align_pairs", "band_align_tb"):
        tensors = pair_inputs(random_pairs(9, 64, 32), "cpu")
    else:
        tensors = align_torch.pad_alignment_inputs(*random_pairs(9, 64, 32))
    inputs = [_CudaLike(t, dev) for t in tensors]
    wrapper = {"band_align": align_cuda.band_align_padded,
               "band_align_tb": align_cuda.band_align_traceback_pairs,
               "band_align_pairs": align_cuda.band_align_pairs}[name]
    before = align_cuda.launches()
    wrapper(*inputs)
    assert launched_on == [dev]
    assert current == [torch.device("cuda", 0)]
    before["band_align_tb" if name == "band_align_tb" else "band_align"] += 1
    assert align_cuda.launches() == before


@pytest.mark.cuda
def test_kernels_launch_on_the_last_card(cuda_device):
    """With two cards or more, both kernels run on cuda:{count-1} and
    match their plain versions there; the current device is unchanged."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", count - 1)
    before = torch.cuda.current_device()
    padded = align_torch.pad_alignment_inputs(*random_pairs(10, 2000, 100),
                                              device=dev)
    got = align_cuda.band_align_padded(*padded)
    assert torch.equal(got, align_torch.band_align_padded_reference(*padded))
    args = pair_inputs(random_pairs(10, 2000, 100), dev, overhang_seed=10)
    assert torch.equal(align_cuda.band_align_pairs(*args),
                       align_torch.band_align_pairs_reference(*args))
    for g, w in zip(align_cuda.band_align_traceback_pairs(*args),
                    align_torch.band_align_traceback_pairs_reference(*args)):
        assert torch.equal(g, w)
    torch.cuda.synchronize(dev)
    assert got.device == dev and torch.cuda.current_device() == before
