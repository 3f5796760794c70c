"""Synthetic datasets of chip_smoke.py and the torch port's tests, and
their checks.

    python tests/test_torch_smoke_data.py slice WORKDIR MB
    python tests/test_torch_smoke_data.py hla WORKDIR [N_ALLELES REGION_LEN COVERAGE]
    python tests/test_torch_smoke_data.py cohort WORKDIR N_SAMPLES LENGTH COVERAGE

builds (or reuses) the dataset in WORKDIR and prints its paths as one JSON
object on the last line.  chip_smoke.build_dataset runs it so, in a child
process, because the writers (tests/synth.py, platypus_tpu.io.tabix,
platypus_tpu.native's BAM indexer) belong to the JAX package and the smoke
imports none of it.
"""

from __future__ import annotations

import gzip
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def slice_dataset(workdir, mb):
    """The synthetic `mb` Mb, 30x, 100 bp dataset of tools/scaling_bench.py
    (variants every 600-1400 bp), cached in `workdir`; returns dict(bam,
    ref, length, n_reads)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from scaling_bench import build_dataset

    return build_dataset(workdir, int(mb * 1_000_000))


def cohort_dataset(workdir, n_samples, length, coverage, seed=11):
    """tools/cohort_bench.py's cohort (build_cohort): one indexed BAM per
    sample (read group sample S000, S001, ...) over one synthetic chr20 of
    `length` bp, common SNPs at drawn frequencies and one private SNP per
    sample, 100 bp reads at `coverage`x each.  Cached in `workdir`; returns
    dict(bam (the BAMs joined by commas, as --bamFiles takes them), ref,
    length, n_reads, n_samples, region)."""
    meta = os.path.join(workdir, "cohort.json")
    if os.path.exists(meta):
        with open(meta) as fh:
            return json.load(fh)
    os.makedirs(workdir, exist_ok=True)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from cohort_bench import build_cohort

    ref, bams, n_reads = build_cohort(workdir, n_samples, length, coverage,
                                      seed=seed)
    info = dict(bam=",".join(bams), ref=ref, length=length, n_reads=n_reads,
                n_samples=n_samples, region=f"chr20:1-{length}")
    with open(f"{meta}.tmp", "w") as fh:
        json.dump(info, fh)
    os.replace(f"{meta}.tmp", meta)
    return info


def hla_dataset(workdir, n_alleles=160, region_len=2000, coverage=30, seed=41):
    """A synthetic HLA typing panel built as tests/test_hla.py builds one:
    contig "6" with the region [2000, 2000 + region_len), a tabix source
    VCF of n_alleles whole-region replacement alleles (1% SNPs each,
    HLAAllele=A*nn), and 100 bp reads at `coverage` drawn alternately from
    alleles 1 and 2 (0.2% substitution errors).  Cached in `workdir`;
    returns dict(bam, ref, panel, region) with a 1-based --regions string."""
    import numpy as np

    from platypus_tpu.io.tabix import write_tabix_vcf
    from synth import make_reference, write_synth_bam

    os.makedirs(workdir, exist_ok=True)
    start, end = 2000, 2000 + region_len
    info = dict(bam=os.path.join(workdir, "reads.bam"),
                ref=os.path.join(workdir, "ref.fa"),
                panel=os.path.join(workdir, "panel.vcf.gz"),
                region=f"6:{start + 1}-{end}")
    if all(os.path.exists(info[k]) for k in ("bam", "ref", "panel")):
        return info
    contig_len = end + 2000
    _, ref_seq = make_reference(workdir, length=contig_len, seed=seed, name="6")
    genome = ref_seq.tobytes()
    region_ref = genome[start:end]
    rng = np.random.default_rng(seed + 1)
    alleles = []
    for _ in range(n_alleles):
        allele = bytearray(region_ref)
        for p in rng.choice(region_len, size=max(1, region_len // 100),
                            replace=False):
            allele[p] = int(rng.choice([b for b in b"ACGT" if b != allele[p]]))
        alleles.append(bytes(allele))
    lines = ["##fileformat=VCFv4.0",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    lines += [f"6\t{start + 1}\t.\t{region_ref.decode()}\t{a.decode()}"
              f"\t100\tPASS\tHLAAllele=A*{k:02d}" for k, a in enumerate(alleles)]
    write_tabix_vcf(lines, info["panel"])

    genomes = [genome[:start] + alleles[k] + genome[end:] for k in (1, 2)]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(coverage * (region_len + 200) // 100):
        pos = int(rng.integers(start - 100, end))
        seq = np.frombuffer(genomes[i % 2][pos : pos + 100], np.uint8).copy()
        err = rng.random(100) < 0.002
        seq[err] = acgt[rng.integers(0, 4, int(err.sum()))]
        reads.append(dict(name=f"r{i}", ref_id=0, pos=pos, mapq=60, flag=0,
                          cigar=[(0, 100)], seq=seq.tobytes(), qual=[35] * 100))
    reads.sort(key=lambda r: r["pos"])
    write_synth_bam(workdir, reads, ref_name="6", ref_len=contig_len)
    return info


def _panel_alleles(path):
    with gzip.open(path, "rt") as fh:
        return [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#")]


def test_hla_panel_outnumbers_the_ranking_cap(tmp_path):
    """The panel holds n_alleles distinct region-length alleles, more than
    the HLA path keeps without its two-round ranking, and a rebuild in
    the same directory reuses it."""
    from platypus_tpu.engine.hla import HLA_MAX_HAPLOTYPES

    info = hla_dataset(str(tmp_path), n_alleles=160, region_len=300,
                       coverage=2)
    rows = _panel_alleles(info["panel"])
    assert len(rows) == 160 > HLA_MAX_HAPLOTYPES
    assert {len(r[4]) for r in rows} == {300} and len({r[4] for r in rows}) == 160
    assert [r[7] for r in rows[:2]] == ["HLAAllele=A*00", "HLAAllele=A*01"]
    mtime = os.path.getmtime(info["bam"])
    assert hla_dataset(str(tmp_path), n_alleles=160, region_len=300,
                       coverage=2) == info
    assert os.path.getmtime(info["bam"]) == mtime


@pytest.mark.parametrize("kind,args", [("slice", (0.02,)),
                                       ("hla", (160, 300, 2)),
                                       ("cohort", (3, 4000, 2))])
def test_child_build_matches_in_process_build(tmp_path, kind, args):
    """chip_smoke.build_dataset (this file's command line in a child
    process) builds the same dataset as the function, without importing
    jax (the child fails if it does)."""
    from chip_smoke import build_dataset

    build = BUILDERS[kind]
    info = build_dataset(kind, str(tmp_path), *args)
    assert os.path.exists(info["ref"])
    assert all(os.path.exists(bam) for bam in info["bam"].split(","))
    assert build(str(tmp_path), *args) == info


BUILDERS = {"slice": slice_dataset, "hla": hla_dataset,
            "cohort": cohort_dataset}


def main(argv) -> int:
    kind, workdir, *args = argv
    build = BUILDERS[kind]
    info = build(workdir, *(float(a) if "." in a else int(a) for a in args))
    if "jax" in sys.modules:
        raise RuntimeError("building a dataset imported jax")
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)  # the script's own directory, tests/, is first
    sys.exit(main(sys.argv[1:]))
