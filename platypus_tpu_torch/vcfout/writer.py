"""VCF 4.0 writer.

Produces the reference caller's output dialect
(Platypus src/python/vcf.py + vcfutils.pyx header signatures): the
same INFO/FILTER/FORMAT header definitions, a `platypusOptions` header line
that round-trips the full config (the resume mechanism parses it back,
runner.py:173-193), and data lines with alphabetically ordered INFO keys.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Optional, Sequence, TextIO

INFO_HEADERS = [
    ("FR", ".", "Float", "Estimated population frequency of variant"),
    ("MMLQ", "1", "Float", "Median minimum base quality for bases around variant"),
    ("TCR", "1", "Integer", "Total reverse strand coverage at this locus"),
    ("HP", "1", "Integer", "Homopolymer run length around variant locus"),
    ("WE", "1", "Integer", "End position of calling window"),
    ("Source", ".", "String", "Was this variant suggested by Playtypus, Assembler, or from a VCF?"),
    ("FS", ".", "Float", "Fisher's exact test for strand bias (Phred scale)"),
    ("WS", "1", "Integer", "Starting position of calling window"),
    ("PP", ".", "Float", "Posterior probability (phred scaled) that this variant segregates"),
    ("TR", ".", "Integer", "Total number of reads containing this variant"),
    ("NF", ".", "Integer", "Total number of forward reads containing this variant"),
    ("TCF", "1", "Integer", "Total forward strand coverage at this locus"),
    ("NR", ".", "Integer", "Total number of reverse reads containing this variant"),
    ("TC", "1", "Integer", "Total coverage at this locus"),
    ("END", ".", "Integer", "End position of reference call block"),
    ("MGOF", ".", "Integer", "Worst goodness-of-fit value reported across all samples"),
    ("SbPval", ".", "Float", "Binomial P-value for strand bias test"),
    ("START", ".", "Integer", "Start position of reference call block"),
    ("ReadPosRankSum", ".", "Float",
     "Mann-Whitney Rank sum test for difference between in positions of variants in reads from ref and alt"),
    ("MQ", ".", "Float", "Root mean square of mapping qualities of reads at the variant position"),
    ("QD", "1", "Float", "Variant-quality/read-depth for this variant"),
    ("SC", "1", "String", "Genomic sequence 10 bases either side of variant position"),
    ("BRF", "1", "Float", "Fraction of reads around this variant that failed filters"),
    ("HapScore", ".", "Integer",
     "Haplotype score measuring the number of haplotypes the variant is segregating into in a window"),
    ("Size", ".", "Integer", "Size of reference call block"),
]

FILTER_HEADERS = [
    ("GOF", "Variant fails goodness-of-fit test."),
    ("badReads",
     "Variant supported only by reads with low quality bases close to variant position, and not present on both strands."),
    ("alleleBias", "Variant frequency is lower than expected for het"),
    ("hp10", "Flanking sequence contains homopolymer of length 10 or greater"),
    ("Q20", "Variant quality is below 20."),
    ("HapScore", "Too many haplotypes are supported by the data in this region."),
    ("MQ", "Root-mean-square mapping quality across calling region is low."),
    ("strandBias", "Variant fails strand-bias filter."),
    ("SC", "Variants fail sequence-context filter. Surrounding sequence is low-complexity"),
    ("QualDepth", "Variant quality/Read depth ratio is low."),
    ("REFCALL", "This line represents a homozygous reference call"),
    ("QD", "Variants fail quality/depth filter."),
]

FORMAT_HEADERS = [
    ("GT", "1", "String", "Unphased genotypes"),
    ("GL", ".", "Float",
     "Genotype log10-likelihoods for AA,AB and BB genotypes, where A = ref and B = variant. Only applicable for bi-allelic sites"),
    ("GOF", ".", "Float", "Goodness of fit value"),
    ("GQ", ".", "Integer", "Genotype quality as phred score"),
    ("NR", ".", "Integer", "Number of reads covering variant location in this sample"),
    ("NV", ".", "Integer", "Number of reads containing variant in this sample"),
]

FILTER_NAMES = {name for name, _ in FILTER_HEADERS}


def _py2_float_str(x: float) -> str:
    """The reference emits floats through py2's str(): 12-significant-digit
    'g' with a trailing .0 for integral values (MQ=60.0, SbPval=1.0,
    GL 0.0, QD at full 12-digit precision).  Verified against the RUNNING
    reference (docs/REFERENCE_RUN.md)."""
    s = "%.12g" % x
    if "." not in s and "e" not in s and "n" not in s:
        s += ".0"
    return s


def _fmt1(x) -> str:
    """VCFWriter._fmt_value with exact-type fast paths."""
    tx = type(x)
    if tx is str:
        return x
    if tx is int:
        return str(x)
    if tx is float:
        return _py2_float_str(x)
    if isinstance(x, float):
        return _py2_float_str(x)
    if isinstance(x, bytes):
        return x.decode()
    return str(x)


class VCFWriter:
    """VCF emitter with the reference's 100-line look-ahead sort.

    The reference's merge step (runner.py FileForQueueing) streams output
    lines through a 100-line heap keyed by (chrom-as-int-if-possible,
    pos, line), so any local inversion within 100 lines — e.g. a gap
    REFCALL block whose start exceeds the following padded window's
    start — comes out position-sorted, with ties broken by full-line
    lexicographic order.  `drain()` flushes the buffer; the region driver
    drains at region boundaries so the crash-rescue/resume durability
    contract (all of a region's lines on disk at on_region_done) holds."""

    def __init__(self, out: TextIO, samples: Sequence[str],
                 options_line: Optional[str] = None, source_version: str = "0.1.0"):
        self.out = out
        self.samples = list(samples)
        self.options_line = options_line
        self.source_version = source_version
        self._heap: list = []

    @staticmethod
    def _chrom_key(chrom: str):
        try:
            return int(chrom.upper().strip("CHR"))
        except ValueError:
            return chrom

    def _emit(self, chrom: str, pos1: int, line: str) -> None:
        import heapq

        heapq.heappush(self._heap, (self._chrom_key(chrom), pos1, line))
        if len(self._heap) > 100:
            self.out.write(heapq.heappop(self._heap)[2])

    def emit_lines(self, chrom: str, text: bytes, meta: List[int]) -> None:
        """_emit each of a window's lines: `text` holds them back to back,
        meta their (1-based position, end offset) pairs."""
        import heapq

        key = self._chrom_key(chrom)
        heap = self._heap
        start = 0
        for k in range(0, len(meta), 2):
            end = meta[k + 1]
            heapq.heappush(heap, (key, meta[k], text[start:end].decode()))
            start = end
            if len(heap) > 100:
                self.out.write(heapq.heappop(heap)[2])

    def sample_columns(self, buffers) -> Optional[List[int]]:
        """The index in `buffers` of each output sample (the last buffer of
        that name, as a dict keyed by name keeps it); None where a sample
        has no buffer."""
        index = {buf.sample: i for i, buf in enumerate(buffers)}
        cols = [index.get(sample) for sample in self.samples]
        return None if None in cols else cols

    def drain(self) -> None:
        """Flush the look-ahead buffer (end of a region / end of run)."""
        import heapq

        while self._heap:
            self.out.write(heapq.heappop(self._heap)[2])

    def write_header(self) -> None:
        w = self.out.write
        w("##fileformat=VCFv4.0\n")
        w(f"##fileDate={datetime.date.fromtimestamp(time.time())}\n")
        w(f"##source=PlatypusTPU_Version_{self.source_version}\n")
        if self.options_line is not None:
            w(f"##platypusOptions={self.options_line}\n")
        for name, number, typ, desc in INFO_HEADERS:
            w(f'##INFO=<ID={name},Number={number},Type={typ},Description="{desc}">\n')
        for name, desc in FILTER_HEADERS:
            w(f'##FILTER=<ID={name},Description="{desc}">\n')
        for name, number, typ, desc in FORMAT_HEADERS:
            w(f'##FORMAT=<ID={name},Number={number},Type={typ},Description="{desc}">\n')
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
        cols.extend(self.samples)
        w("\t".join(cols) + "\n")

    @staticmethod
    def _fmt_value(v) -> str:
        if isinstance(v, float):
            return _py2_float_str(v)
        if isinstance(v, bytes):
            return v.decode()
        return str(v)

    def write_record(
        self,
        chrom: str,
        pos: int,             # 0-based internal; written 1-based
        ref: str,
        alts: List[str],
        qual,
        filters: List[str],
        info: Dict[str, list],
        format_keys: List[str],
        sample_data: Dict[str, Dict[str, list]],
        record_id: str = ".",
    ) -> None:
        # Hot path: one call per emitted record.  _fmt1 is _fmt_value with
        # exact-type fast paths, and single-element value lists (the common
        # case for INFO and most FORMAT fields) skip the join machinery.
        fmt1 = _fmt1
        info_parts = []
        for k in sorted(info):
            v = info[k]
            if len(v) == 1:
                info_parts.append(k + "=" + fmt1(v[0]))
            else:
                info_parts.append(k + "=" + ",".join([fmt1(x) for x in v]))
        cols = [
            chrom,
            str(pos + 1),
            record_id,
            ref,
            ",".join(alts) if alts else ".",
            fmt1(qual),
            ";".join(sorted(filters)) if filters else "PASS",
            ";".join(info_parts),
            ":".join(format_keys),
        ]
        for sample in self.samples:
            data = sample_data[sample]
            fields = []
            for key in format_keys:
                val = data[key]
                if key == "GT":
                    fields.append("".join(map(str, val[0])))
                elif len(val) == 1:
                    fields.append(fmt1(val[0]))
                else:
                    fields.append(",".join([fmt1(x) for x in val]))
            cols.append(":".join(fields))
        self._emit(chrom, pos + 1, "\t".join(cols) + "\n")
