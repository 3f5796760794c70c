"""The frozen plain versions equal the port's plain versions at small
sizes, and the calls are judged as intended."""

import numpy as np
import torch

from conftest_util import tiny_cell  # noqa: F401
from portbench.reference import calls, dp, em

ACGT = torch.tensor(np.frombuffer(b"ACGTN", np.uint8).copy())


def _pairs(seed, H=20, L1B=300, A=60, L2=100, B=700):
    g = torch.Generator().manual_seed(seed)
    hap = ACGT[torch.randint(0, 5, (H, L1B), generator=g)]
    go = torch.randint(10, 45, (H, L1B), generator=g).to(torch.uint8)
    seq = ACGT[torch.randint(0, 5, (A, L2), generator=g)]
    qual = torch.randint(2, 41, (A, L2), generator=g).to(torch.uint8)
    ph = torch.randint(0, H, (B,), generator=g).int()
    pr = torch.randint(0, A, (B,), generator=g).int()
    ps = torch.randint(0, L1B - 60, (B,), generator=g).int()
    rl = torch.randint(30, L2 + 1, (B,), generator=g).int()
    return hap, go, seq, qual, ph, pr, ps, rl


def test_frozen_dp_equals_the_ports_plain_dp():
    from platypus_tpu_torch.ops.align_torch import band_align_pairs_reference

    for seed in (1, 2):
        args = _pairs(seed)
        for ge, npr in ((3, 2), (2, 4)):
            assert torch.equal(
                dp.band_align_pairs(*args, gapextend=ge, nucprior=npr),
                band_align_pairs_reference(*args, gapextend=ge, nucprior=npr))


def _batch(seed, W=5, H=4, R=48, I=3, V=3):
    from platypus_tpu_torch.ops.likelihood import genotype_index_pairs

    g = torch.Generator().manual_seed(seed)
    ll = -torch.rand(W, H, R, generator=g) * 25
    oh = torch.zeros(W, I, R)
    oh[:, torch.arange(R) % I, torch.arange(R)] = 1
    hm = torch.ones(W, H, dtype=torch.bool)
    hm[0, H - 1] = False
    h1, h2 = (torch.tensor(a, dtype=torch.int32) for a in genotype_index_pairs(H))
    vm = torch.rand(W, V, H, generator=g) < 0.5
    hr = torch.ones(W, I, dtype=torch.bool)
    hr[1, 0] = False
    return ll, oh, hm, h1, h2, vm, hr


def test_frozen_inference_equals_the_ports_plain_inference():
    """In float64: the BLAS's float32 products may round differently with
    the alignment of their buffers, so two equal programs need not agree
    in every float32 bit."""
    from platypus_tpu_torch.ops.likelihood_torch import infer_window_batch

    for seed in (3, 4):
        ll, oh, *rest = _batch(seed)
        args = (ll.double(), oh.double(), *rest)
        for got, want in zip(em.infer_window_batch(*args),
                             infer_window_batch(*args)):
            torch.testing.assert_close(got, want, rtol=1e-12, atol=0,
                                       equal_nan=True)


def test_calls_match_any_padding_and_count_genotypes():
    ref = np.frombuffer(b"ACGT" * 100, np.uint8)
    # an insertion of "TA" before 0-based 202 and a SNV at 250
    truth = [(202, 0, b"TA", [[1, 0]]), (250, 1, b"A", [[1, 1]])]
    vcf = "\n".join([
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        f"c\t202\t.\t{chr(ref[201])}\t{chr(ref[201])}TA\t50\tPASS\t.\tGT\t0/1",
        f"c\t251\t.\t{chr(ref[250])}\tA\t50\tPASS\t.\tGT\t0/1",
        f"c\t300\t.\t{chr(ref[299])}\tG\t50\tPASS\t.\tGT\t0/1",
        f"c\t320\t.\t{chr(ref[319])}\tG\t5\tQ20\t.\tGT\t0/1"])
    t = calls.judge_region(ref, 0, 400, calls.parse_records(vcf), truth)
    assert (t.sites, t.missed, t.genotypes, t.genotype_errors) == (2, 0, 2, 1)
    assert (t.records, t.extra) == (3, 1)
