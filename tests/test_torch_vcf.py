"""The torch port's copies of the general VCF library (io/vcf.py) and the
plain reader (io/vcfreader.py) against the JAX package's: the cases of
tests/test_vcf_general.py, test_compression_vcfreader.py
test_vcf_reader_own_output and test_robustness.py's VCFReader check, each
run through both packages on the same text or file.  Records and errors
must be equal; each package raises its own VCFError."""

import dataclasses
import io

import pytest

from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam
from test_vcf_general import V33, V40, _FakeRef
from torch_twin_util import JAX_PKG, PORT_PKG, module

PKGS = (JAX_PKG, PORT_PKG)


def _both(case):
    """case(pkg) for both packages; asserts equal results, returns one."""
    got = {pkg: case(pkg) for pkg in PKGS}
    assert got[PORT_PKG] == got[JAX_PKG]
    return got[PORT_PKG]


def _vcf(pkg):
    return module(pkg, "io.vcf")


def _parse(pkg, text, **kw):
    return list(_vcf(pkg).VCF(**kw).parse(io.StringIO(text)))


def _error(pkg, fn):
    """(name of the exception, its message) that fn() raises; the
    exception must be the package's own VCFError."""
    with pytest.raises(_vcf(pkg).VCFError) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def test_v40_typed_parse():
    def case(pkg):
        v = _vcf(pkg).VCF()
        recs = list(v.parse(io.StringIO(V40)))
        assert v.getsamples() == ["S1", "S2"]
        assert v.getinfo()["FR"].numbertype == _vcf(pkg).VCF.NT_ALLELES
        assert v.getformat()["GL"].numbertype == _vcf(pkg).VCF.NT_GENOTYPES
        assert recs[0]["S1"]["GL"] == [-1.0, 0.0, -2.0]
        assert recs[1]["S2"]["NR"] == [None]
        return (recs, v.getheader(), sorted(v.getinfo()), sorted(v.getformat()),
                [dataclasses.astuple(v.getinfo()[k])[:5] for k in sorted(v.getinfo())])

    _both(case)


def test_region_filter_and_parse_regions():
    def case(pkg):
        regions = _vcf(pkg).parse_regions("chr1:150-300")
        recs = _parse(pkg, V40, regions=regions)
        assert len(recs) == 1 and recs[0]["pos"] == 199
        return regions, recs

    _both(case)


def test_error_policy():
    bad = V40.replace('##FILTER=<ID=badReads,Description="Low quality">\n', "")

    def case(pkg):
        err = _error(pkg, lambda: _parse(pkg, bad))
        assert "badReads" in err[1]
        v = _vcf(pkg).VCF()
        v.ignoreerror("FILTER_NOT_DEFINED")
        ignored = list(v.parse(io.StringIO(bad)))
        v2 = _vcf(pkg).VCF()
        v2.warnerror("FILTER_NOT_DEFINED")
        warned = list(v2.parse(io.StringIO(bad)))
        assert len(ignored) == len(warned) == 2
        with pytest.raises(ValueError) as unknown:
            v2.ignoreerror("NO_SUCH_ERROR")
        return err, ignored, warned, str(unknown.value)

    _both(case)


def test_v33_allele_conversion():
    def case(pkg):
        recs = _parse(pkg, V33, reference=_FakeRef("TTTTACCTGGTT"))
        assert (recs[1]["ref"], recs[1]["alt"]) == ("CCT", ["C"])
        assert (recs[2]["ref"], recs[2]["alt"]) == ("G", ["GAA"])
        return recs

    _both(case)


def test_v33_named_deletion_without_reference():
    text = ("##fileformat=VCFv3.3\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            "chr1\t100\t.\tA\tDAG\t60\t0\t.\tGT\t0/1\n")

    def case(pkg):
        recs = _parse(pkg, text)
        assert len(recs) == 1
        assert len(recs[0]["ref"]) == len(recs[0]["alt"][0]) + 2
        return recs

    _both(case)


def test_v33_converted_alleles_still_anchor_checked():
    def case(pkg):
        recs = _parse(pkg, V33, reference=_FakeRef("TTTTACCTGGTT"))
        for r in recs:
            for a in r["alt"]:
                if len(a) != len(r["ref"]):
                    assert a[:1] == r["ref"][:1]
        # A v3.3 deletion that disagrees with the reference is an error.
        return recs, _error(pkg, lambda: _parse(
            pkg, V33.replace("\tC\tD2\t", "\tG\tD2\t"),
            reference=_FakeRef("TTTTACCTGGTT")))

    _both(case)


def test_trailing_base_trim_and_compare():
    text = ("##fileformat=VCFv4.0\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            "chr1\t10\t.\tTACA\tTA\t50\t.\t.\tGT\t0/1\n")

    def case(pkg):
        r = _parse(pkg, text)[0]
        assert (r["ref"], r["alt"]) == ("TAC", ["T"])
        v = _vcf(pkg).VCF()
        compared = [v.compare_calls(9, "TAC", "T", 9, "TACA", "TA"),
                    v.compare_calls(9, "TAC", "T", 10, "TAC", "T"),
                    v.compare_calls(9, "T", "TG", 9, "T", "TC"),
                    v.compare_calls(9, "TAC", "T", 9, "TAG", "T")]
        assert compared == [True, False, False, True]
        return r, compared

    _both(case)


def test_write_round_trip():
    def case(pkg):
        v = _vcf(pkg).VCF()
        recs = list(v.parse(io.StringIO(V40)))
        out = io.StringIO()
        v.write(out, recs)
        recs2 = _parse(pkg, out.getvalue())
        assert [r["S1"]["GT"] for r in recs2] == [r["S1"]["GT"] for r in recs]
        return out.getvalue(), recs2

    _both(case)


def test_sorted_vcf_orders_chromosomes():
    text = ("##fileformat=VCFv4.0\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            "chr10\t5\t.\tA\tG\t50\t.\t.\tGT\t0/1\n"
            "chr2\t9\t.\tC\tT\t50\t.\t.\tGT\t0/1\n"
            "chr2\t3\t.\tG\tA\t50\t.\t.\tGT\t0/1\n"
            "chrX\t1\t.\tT\tC\t50\t.\t.\tGT\t0/1\n")

    def case(pkg):
        sv = _vcf(pkg).sortedVCF()
        recs = list(sv.parse(io.StringIO(text)))
        assert [(r["chrom"], r["pos"]) for r in recs] == [
            ("chr2", 2), ("chr2", 8), ("chr10", 4), ("chrX", 0)]
        return recs, list(sv.parse(None, region=("chr2", 0, 5)))

    _both(case)


def test_v41_symbolic_del_allowed():
    text = ("##fileformat=VCFv4.1\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            "chr1\t10\t.\tT\t<DEL>\t50\t.\t.\tGT\t0/1\n")

    def case(pkg):
        r = _parse(pkg, text)[0]
        assert r["alt"] == ["<DEL>"]
        err = _error(pkg, lambda: _parse(pkg, text.replace("VCFv4.1", "VCFv4.0")))
        assert "V40_BAD_ALLELE" in err[1]
        return r, err

    _both(case)


def _reader_records(pkg, source):
    reader = module(pkg, "io.vcfreader").VCFReader(source)
    with reader:
        header = (reader.samples, reader.platypus_options, reader.meta,
                  {k: dataclasses.asdict(f) for k, f in reader.infos.items()},
                  sorted(reader.filters), sorted(reader.formats))
        return header, [dataclasses.asdict(rec) for rec in reader]


def test_vcf_reader_own_output():
    """Each package's writer output parses back through each package's
    reader with the same typed fields."""
    def written(pkg):
        buf = io.StringIO()
        w = module(pkg, "vcfout.writer").VCFWriter(buf, ["S1"],
                                                   options_line='{"x": 1}')
        w.write_header()
        w.write_record(
            "chr1", 99, "A", ["G"], 50, ["alleleBias"],
            {"TC": [10], "PP": ["50"], "FR": ["0.5000"]},
            ["GT", "GL", "GOF", "GQ", "NR", "NV"],
            {"S1": dict(GT=[["0", "/", "1"]], GL=[-10.0, 0, -8.2], GOF=[3],
                        GQ=[42], NR=[10], NV=[5])})
        w.drain()
        return buf.getvalue()

    text = _both(written)

    def case(pkg):
        r = module(pkg, "io.vcfreader").VCFReader(io.StringIO(text))
        assert r.samples == ["S1"] and r.platypus_options == '{"x": 1}'
        rec = list(r)[0]
        assert rec.pos == 100 and rec.sample_gt("S1") == ("0", "1")
        assert rec.sample_floats("S1", "GL") == [-10.0, 0.0, -8.2]
        return _reader_records(pkg, io.StringIO(text))

    _both(case)


def test_vcf_reader_on_a_called_vcf(tmp_path):
    """test_robustness.py's check: the VCF of a run (here the port's, on
    the CPU) parses through both readers, from a file and gzip-compressed,
    to the same records."""
    import gzip

    import torch

    from platypus_tpu_torch.config import PlatypusConfig
    from platypus_tpu_torch.engine.runner import run_single_process

    ref_path, ref_seq = make_reference(tmp_path, length=3000, seed=81)
    variants = [(p, 1, b"A" if ref_seq[p] != ord("A") else b"G")
                for p in (120, 1500)]
    reads = simulate_reads([SimHaplotype(ref_seq, []),
                            SimHaplotype(ref_seq, variants)],
                           0, 3000, coverage=35, seed=82)
    bam = write_synth_bam(tmp_path, reads, ref_len=3000)
    out = str(tmp_path / "edge.vcf")
    run_single_process(PlatypusConfig(bam_files=[bam], ref_file=ref_path),
                       [("chr20", 0, 3000)], out, torch.device("cpu"))
    with open(out, "rb") as src, gzip.open(f"{out}.gz", "wb") as dst:
        dst.write(src.read())
    header, recs = _both(lambda pkg: _reader_records(pkg, out))
    assert _both(lambda pkg: _reader_records(pkg, f"{out}.gz")) == (header, recs)
    assert {r["pos"] - 1 for r in recs} >= {120, 1500}
