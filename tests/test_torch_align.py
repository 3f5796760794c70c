"""The torch port's banded-alignment inputs and plain DPs
(platypus_tpu_torch/ops/align_torch.py) against the checked-in reference
goldens, the JAX scan kernel and the Pallas kernels (interpret mode on the
CPU): the scoring DP and its traceback mode.  Scores, exit indices and
label words are integers: every comparison is bitwise."""

import numpy as np
import pytest
import torch

from chip_smoke import (flank_golden_mismatches, flank_goldens, golden_groups,
                        pair_inputs, tie_pairs)
from platypus_tpu.ops.align_jax import (_gather_pad_device, band_align_padded,
                                        pad_alignment_inputs)
from platypus_tpu.ops.align_pallas import (band_align_padded_pallas,
                                           band_align_traceback_padded_pallas)
from platypus_tpu_torch.ops import align_cuda, align_torch


BASES = np.frombuffer(b"ACGT", np.uint8)


def _random_case(seed, B, L2, n_frac=0.0, mixed=True):
    """test_align.py:82-106 style pairs: reads cut from the hap at a band
    offset, point mutations, random quals and gap opens; optional 'N'
    bases in hap and read."""
    rng = np.random.default_rng(seed)
    hap = rng.choice(BASES, size=(B, L2 + 15)).astype(np.int32)
    go = rng.integers(3, 50, size=(B, L2 + 15)).astype(np.int32)
    read = np.zeros((B, L2), np.int32)
    for b in range(B):
        off = rng.integers(0, 8)
        read[b] = hap[b, off : off + L2]
    n_mut = 200 * B // 128
    mut = rng.integers(0, B, n_mut), rng.integers(0, L2, n_mut)
    read[mut] = rng.choice(BASES, n_mut)
    if n_frac:
        hap[rng.random(hap.shape) < n_frac] = ord("N")
        read[rng.random(read.shape) < n_frac] = ord("N")
    qual = rng.integers(0, 60, size=(B, L2)).astype(np.int32)
    lo = 10 if mixed else L2
    rl = rng.integers(lo, L2 + 1, size=B).astype(np.int32)
    return hap, go, read, qual, rl


def test_plain_dp_matches_goldens():
    n = 0
    for ge, npr, inputs, want in golden_groups():
        got = align_torch.band_align_batch(*inputs, gapextend=ge, nucprior=npr)
        np.testing.assert_array_equal(got, want, err_msg=f"ge={ge} npr={npr}")
        n += len(want)
    assert n >= 300


def test_cuda_wrapper_on_cpu_tensors_runs_plain_dp():
    """A CPU tensor reaches the plain version; the kernel counter stays."""
    before = align_cuda.launches()
    for ge, npr, inputs, want in golden_groups():
        padded = align_torch.pad_alignment_inputs(*inputs)
        got = align_cuda.band_align_padded(*padded, gapextend=ge, nucprior=npr)
        np.testing.assert_array_equal(got.numpy(), want)
    assert align_cuda.launches() == before


@pytest.mark.parametrize("seed,B,L2,n_frac,mixed", [
    (7, 128, 40, 0.0, True),     # the test_align.py:82 case
    (11, 128, 32, 0.0, False),   # all reads full length
    (13, 200, 40, 0.03, True),   # B not a multiple of 128, 'N' bases
    (17, 64, 100, 0.01, True),   # main-path read length
])
def test_plain_dp_matches_jax_and_pallas(seed, B, L2, n_frac, mixed):
    inputs = _random_case(seed, B, L2, n_frac, mixed)
    jax_padded = pad_alignment_inputs(*inputs)
    want = np.asarray(band_align_padded(*jax_padded))
    np.testing.assert_array_equal(
        np.asarray(band_align_padded_pallas(*jax_padded)), want)
    padded = align_torch.pad_alignment_inputs(*inputs)
    for ours, theirs in zip(padded, jax_padded):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    got = align_torch.band_align_padded_reference(*padded).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("overhang", [False, True])
def test_gather_pad_matches_jax(overhang):
    """gather_pad == _gather_pad_device, including segments that run past
    the matrix width (JAX clamps those column indices)."""
    rng = np.random.default_rng(5 + overhang)
    H, A, L2, L1B, B = 6, 40, 32, 96, 300
    hap_mat = rng.choice(BASES, size=(H, L1B)).astype(np.uint8)
    hap_mat[:, -5:] = ord("N")
    go_mat = rng.integers(3, 79, size=(H, L1B)).astype(np.uint8)
    seq_mat = rng.choice(BASES, size=(A, L2)).astype(np.uint8)
    qual_mat = rng.integers(0, 60, size=(A, L2)).astype(np.uint8)
    ph = rng.integers(0, H, B).astype(np.int32)
    pr = rng.integers(0, A, B).astype(np.int32)
    hi = L1B - 10 if overhang else L1B - (L2 + 15)
    ps = rng.integers(0, hi, B).astype(np.int32)
    if overhang:
        ps[:20] = L1B - 3
        assert (ps + L2 + 15 > L1B).any()
    rl = rng.integers(8, L2 + 1, B).astype(np.int32)
    want = _gather_pad_device(hap_mat, go_mat, seq_mat, qual_mat, ph, pr, ps, rl)
    got = align_torch.gather_pad(
        *(torch.from_numpy(a) for a in (hap_mat, go_mat, seq_mat, qual_mat,
                                        ph, pr, ps, rl)))
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(
        align_torch.band_align_padded_reference(*got).numpy(),
        np.asarray(band_align_padded(*want)))


@pytest.mark.parametrize("seed,B,L2,n_frac", [
    (13, 200, 40, 0.03),   # B not a multiple of 128, 'N' bases
    (19, 200, 100, 0.01),  # main-path read length
])
def test_traceback_dp_matches_pallas(seed, B, L2, n_frac):
    """band_align_traceback_padded_reference == the Pallas traceback kernel
    (interpret mode, as tests/test_align.py runs it): score, exit index and
    the whole [(L2+8)*8, B] label block, mixed read lengths."""
    inputs = _random_case(seed, B, L2, n_frac, mixed=True)
    want = [np.asarray(x) for x in band_align_traceback_padded_pallas(
        *pad_alignment_inputs(*inputs))]
    got = align_torch.band_align_traceback_padded_reference(
        *align_torch.pad_alignment_inputs(*inputs))
    assert [g.shape for g in got] == [(B,), (B,), ((L2 + 8) * 8, B)]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_traceback_dp_reproduces_flank_goldens():
    """The flank goldens through the plain traceback DP, then the JAX
    package's host backtrace and flank penalty: score, alignment rows,
    first position and flank score all as checked in."""
    cases, inputs = flank_goldens()
    score, idx, bp = align_torch.band_align_traceback_padded_reference(
        *align_torch.pad_alignment_inputs(*inputs))
    assert len(cases) >= 100
    assert flank_golden_mismatches(cases, score.numpy(), idx.numpy(),
                                   bp.numpy()) == []


def _pair_matrices(seed, B, L2, overhang, n_frac, mixed):
    """Deduplicated matrices as engine/score.py uploads them (uint8 [H,
    L1B] hap / gap-open, [A, L2] read / quality) and int32 pair rows; each
    read is cut from a hap at its pair's segment with point mutations.
    `overhang` starts a third of the segments near the hap's end, past
    which gather/pad clamps the columns."""
    rng = np.random.default_rng(seed)
    H, A = 9, 60
    L1B = 2 * L2 + 40
    hap_mat = rng.choice(BASES, size=(H, L1B)).astype(np.uint8)
    go_mat = rng.integers(3, 79, size=(H, L1B)).astype(np.uint8)
    ph = rng.integers(0, H, B).astype(np.int32)
    pr = rng.integers(0, A, B).astype(np.int32)
    ps = rng.integers(0, L1B - (L2 + 15), B).astype(np.int32)
    if overhang:
        k = max(1, B // 3)
        ps[:k] = rng.integers(L1B - L2, L1B, k)
    lo = 8 if mixed else L2
    rl = rng.integers(lo, L2 + 1, B).astype(np.int32)
    seq_mat = rng.choice(BASES, size=(A, L2)).astype(np.uint8)
    for a in range(A):
        uses = np.nonzero(pr == a)[0]
        if len(uses):
            b = uses[0]
            seg = hap_mat[ph[b], ps[b] + rng.integers(0, 8):][:L2]
            seq_mat[a, : len(seg)] = seg
    mut = rng.random(seq_mat.shape) < 0.02
    seq_mat[mut] = rng.choice(BASES, int(mut.sum()))
    if n_frac:
        hap_mat[rng.random(hap_mat.shape) < n_frac] = ord("N")
        seq_mat[rng.random(seq_mat.shape) < n_frac] = ord("N")
    qual_mat = rng.integers(0, 60, size=(A, L2)).astype(np.uint8)
    return (hap_mat, go_mat, seq_mat, qual_mat), (ph, pr, ps, rl)


# (seed, B, L2, overhang, n_frac, mixed) of _pair_matrices
PAIR_CASES = [
    (21, 300, 40, True, 0.0, True),     # segments past the matrix width
    (22, 256, 40, False, 0.0, True),    # mixed read lengths
    (23, 256, 32, False, 0.03, False),  # 'N' bases, full-length reads
    (24, 200, 40, True, 0.02, True),    # B not a multiple of 128
    (25, 1, 40, False, 0.0, True),      # B = 1
    (26, 64, 128, True, 0.01, True),    # the main path's L2 for 100 bp
]


@pytest.mark.parametrize("seed,B,L2,overhang,n_frac,mixed", PAIR_CASES)
def test_pair_entry_plain_version_matches_jax(seed, B, L2, overhang, n_frac,
                                              mixed):
    """band_align_pairs_reference (K1's pair entry's plain version) ==
    the JAX package's _gather_pad_device followed by its XLA scan and by
    the Pallas kernel in interpret mode, bitwise."""
    mats, idx = _pair_matrices(seed, B, L2, overhang, n_frac, mixed)
    jax_padded = _gather_pad_device(*mats, *idx)
    want = np.asarray(band_align_padded(*jax_padded))
    np.testing.assert_array_equal(
        np.asarray(band_align_padded_pallas(*jax_padded)), want)
    got = align_torch.band_align_pairs_reference(
        *(torch.from_numpy(a) for a in (*mats, *idx)))
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair_wrapper_on_cpu_tensors_runs_plain_version():
    """A CPU tensor reaches the pair entry's plain version; no launch is
    counted."""
    mats, idx = _pair_matrices(27, 100, 40, True, 0.01, True)
    args = [torch.from_numpy(a) for a in (*mats, *idx)]
    before = align_cuda.launches()
    got = align_cuda.band_align_pairs(*args, gapextend=2, nucprior=1)
    want = align_torch.band_align_padded_reference(
        *align_torch.gather_pad(*args), gapextend=2, nucprior=1)
    assert torch.equal(got, want)
    assert align_cuda.launches() == before


@pytest.mark.parametrize("case", PAIR_CASES + ["ties"])
def test_traceback_pair_plain_version_matches_jax(case):
    """band_align_traceback_pairs_reference (K2's pair entry's plain
    version) == the JAX package's _gather_pad_device followed by the
    Pallas traceback kernel in interpret mode: score and exit index
    bitwise, and the int16 label words are the int32 ones, which never use
    bits 16-31.  "ties": homopolymer pairs whose exit cells tie across
    rows and phases."""
    if case == "ties":
        args = pair_inputs(tie_pairs(28, 200, 40), "cpu")
        mats, idx = [a.numpy() for a in args[:4]], [a.numpy() for a in args[4:]]
    else:
        mats, idx = _pair_matrices(*case)
    B, L2 = len(idx[3]), mats[2].shape[1]
    want = [np.asarray(x) for x in band_align_traceback_padded_pallas(
        *_gather_pad_device(*mats, *idx))]
    score, exit_idx, bp = align_torch.band_align_traceback_pairs_reference(
        *(torch.from_numpy(a) for a in (*mats, *idx)))
    assert [t.dtype for t in (score, exit_idx, bp)] == [torch.int32,
                                                        torch.int32,
                                                        torch.int16]
    assert bp.shape == ((L2 + 8) * 8, B)
    np.testing.assert_array_equal(score.numpy(), want[0])
    np.testing.assert_array_equal(exit_idx.numpy(), want[1])
    assert ((want[2] >> 16) == 0).all()
    np.testing.assert_array_equal(bp.view(torch.uint16).numpy(), want[2])


def test_traceback_wrapper_on_cpu_tensors_runs_plain_dp():
    """A CPU tensor reaches K2's pair entry's plain version (the goldens
    through identity indices); no launch is counted."""
    cases, inputs = flank_goldens()
    args = pair_inputs(inputs, "cpu")
    before = align_cuda.launches()
    got = align_cuda.band_align_traceback_pairs(*args)
    score, idx, bp = align_torch.band_align_traceback_padded_reference(
        *align_torch.gather_pad(*args))
    assert torch.equal(got[0], score) and torch.equal(got[1], idx)
    assert torch.equal(got[2].view(torch.uint16).int(), bp)
    np.testing.assert_array_equal(got[0].numpy(), [c["score"] for c in cases])
    assert flank_golden_mismatches(cases, *(t.numpy() for t in got)) == []
    assert align_cuda.launches() == before
