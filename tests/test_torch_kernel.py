"""K1 (platypus_tpu_torch/csrc/band_align.cu) and K2, its traceback mode
(csrc/band_align_tb.cu), on the card, against their plain torch versions.
These tests need a CUDA device and skip without one; this file imports no
jax, so on a machine with a card and without jax run it as

    python -m pytest --noconftest tests/test_torch_kernel.py -m cuda
"""

import pytest
import torch

from chip_smoke import (flank_golden_mismatches, flank_goldens,
                        golden_groups, random_pairs)
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
    before = dict(align_cuda.LAUNCHES)
    align_cuda.band_align_padded(*padded)
    align_cuda.band_align_padded(*padded)
    before["band_align"] += 2
    assert align_cuda.LAUNCHES == before


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
def test_tb_kernel_matches_plain_dp_on_card(cuda_device):
    """K2's score, exit index and label block bitwise on the flank goldens
    (whose alignments the host backtrace then recovers) and on B=2000
    mixed-length pairs with 'N' bases."""
    cases, golden_inputs = flank_goldens()
    for inputs in (golden_inputs, random_pairs(6, 2000, 100)):
        padded = align_torch.pad_alignment_inputs(*inputs, device=cuda_device)
        got = align_cuda.band_align_traceback_padded(*padded)
        want = align_torch.band_align_traceback_padded_reference(*padded)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = align_cuda.band_align_traceback_padded(*align_torch.pad_alignment_inputs(
        *golden_inputs, device=cuda_device))
    assert flank_golden_mismatches(cases, *(t.cpu().numpy() for t in got)) == []


@pytest.mark.cuda
def test_tb_kernel_counts_each_launch(cuda_device):
    padded = align_torch.pad_alignment_inputs(*random_pairs(7, 300, 64),
                                              device=cuda_device)
    before = dict(align_cuda.LAUNCHES)
    align_cuda.band_align_traceback_padded(*padded)
    align_cuda.band_align_traceback_padded(*padded)
    before["band_align_tb"] += 2
    assert align_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_tb_kernel_wrapper_rejects_bad_inputs(cuda_device):
    hap, go, read, qual, rlen = align_torch.pad_alignment_inputs(
        *random_pairs(8, 256, 32), device=cuda_device)
    tb = align_cuda.band_align_traceback_padded
    with pytest.raises(ValueError, match="int32"):
        tb(hap, go, read.long(), qual, rlen)
    with pytest.raises(ValueError, match="contiguous"):
        tb(hap[:, ::2], go[:, ::2], read[:, ::2], qual[:, ::2], rlen[::2])
    with pytest.raises(ValueError, match="int32 on"):
        tb(hap, go, read, qual, rlen.cpu())
