"""The traffic generator is byte-stable per seed and writes indexes a
reader accepts."""

import hashlib
import os

from conftest_util import tiny_cell  # noqa: F401  (puts the root on sys.path)
from portbench.traffic import synth


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d))}


def test_generator_is_byte_stable_per_seed(tmp_path):
    for kind in ("wgs", "cohort"):
        cell = tiny_cell(kind)
        dirs = []
        for k, seed in enumerate((2**40 + 3, 2**40 + 3, 2**40 + 4)):
            d = tmp_path / f"{kind}{k}"
            d.mkdir()
            synth.build(str(d), cell.config, cell.traffic, seed)
            dirs.append(_digests(str(d)))
        assert dirs[0] == dirs[1]
        assert dirs[0]["S000.bam"] != dirs[2]["S000.bam"]


def test_bam_and_index_read_back(tmp_path):
    from platypus_tpu_torch.io.bam import BamFile, build_bai
    from platypus_tpu_torch.io.fasta import FastaFile

    cell = tiny_cell("wgs")
    meta = synth.build(str(tmp_path), cell.config, cell.traffic, 11)
    bam = str(tmp_path / "S000.bam")
    build_bai(bam, str(tmp_path / "streamed.bai"))
    assert (tmp_path / "streamed.bai").read_bytes() == (
        tmp_path / "S000.bam.bai").read_bytes()
    with BamFile(bam) as fh:
        for k, (chrom, start, end) in enumerate(meta["regions"]):
            reads = fh.fetch(chrom, start, end)
            # every read that starts in the region, and those overlapping it
            assert len(reads) >= meta["reads_per_region"][k]
    ref = FastaFile(str(tmp_path / "ref.fa"))
    assert ref.refs[cell.config["contig"]].length == cell.config["genome_length"]


def test_truth_holds_every_planted_site(tmp_path):
    cell = tiny_cell("cohort")
    meta = synth.build(str(tmp_path), cell.config, cell.traffic, 5)
    samples = cell.config["samples"]
    assert all(len(gt) == samples for gt in meta["truth"].values())
    carriers = [sum(map(sum, gt)) for gt in meta["truth"].values()]
    assert min(carriers) >= 1 and max(carriers) <= 2 * samples - 1
    # the 1/k spectrum: singletons are the largest class
    assert carriers.count(1) > carriers.count(2) > carriers.count(5)


def test_genome_model_plants_homozygous_sites_and_indels(tmp_path):
    cell = tiny_cell("wgs")
    meta = synth.build(str(tmp_path), cell.config, cell.traffic, 6)
    truth = meta["truth"]
    hom = sum(gt[0] == [1, 1] for gt in truth.values()) / len(truth)
    indel = sum(k.split(":")[1] != "1" or len(k.split(":")[2]) != 1
                for k in truth) / len(truth)
    assert abs(hom - cell.traffic["variants"]["hom_share"]) < 0.08
    share = 1 - cell.traffic["variants"]["snv"]
    assert abs(indel - share) < 0.06
